"""tools/profile_recon.py's source handling on the CPU (its measurements
need the card): --split-parent's patching of a parent commit's
recon_intra.cu, and the parts an older source is built from;
tools/compare_rates.py's refusal without a card; and the ALF profiling
helpers: chip_smoke.py's counts of the class SSE's ordered chains and of
the gate's dependent adds, and tools/profile_alf_split.py's edits of
csrc/alf.cu."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import profile_recon as pr  # noqa: E402

TEXT = "a\nb\nc\nd\ne\n"
PATCH = ("--- a/x.cu\n+++ b/x.cu\n"
         "@@ -2,2 +2,3 @@\n b\n-c\n+C\n+c2\n"
         "@@ -5,1 +6,2 @@\n e\n+f\n")


def test_apply_patch_places_and_checks_hunks():
    """Each hunk's context and removed lines must be the text's at its
    line; its added lines go in their place."""
    assert pr.apply_patch(TEXT, PATCH) == "a\nb\nC\nc2\nd\ne\nf\n"
    with pytest.raises(ValueError):
        pr.apply_patch("a\nb\nx\nd\ne\n", PATCH)


def test_split_parent_uses_the_revisions_patch(tmp_path, monkeypatch):
    """--split-parent recon_intra_REV.cu takes tools/
    recon_intra_REV_phases.patch and writes the patched source beside the
    file (the helpers it calls exist: an earlier version lost them), and
    an older source is built with the parts it has."""
    (tmp_path / "tools").mkdir()
    (tmp_path / "tools" / "recon_intra_t_phases.patch").write_text(PATCH)
    src = tmp_path / "recon_intra_t.cu"
    src.write_text(TEXT)
    monkeypatch.setattr(pr, "ROOT", str(tmp_path))
    out = pr.parent_phases(str(src))
    assert out == str(tmp_path / "recon_intra_t_phases.cu")
    with open(out) as f:
        assert f.read() == "a\nb\nC\nc2\nd\ne\nf\n"
    quant = pr.part(str(src), "quant")
    with open(quant) as f:
        assert f.read() == ('#define X266_RECON_QUANT_PART\n'
                            '#include "recon_intra_t.cu"\n')


@pytest.mark.parametrize("rev", ["d418144", "74ae6c4"])
def test_committed_phase_patches_parse(rev):
    """The committed phase patches split into hunks whose line counts are
    their headers' (what apply_patch walks)."""
    import re

    with open(os.path.join(ROOT, "tools",
                           f"recon_intra_{rev}_phases.patch")) as f:
        patch = f.read()
    heads = re.findall(r"^@@ -\d+,(\d+) \+\d+,(\d+) @@", patch, flags=re.M)
    bodies = re.split(r"^@@ .*\n", patch, flags=re.M)[1:]
    assert heads and len(heads) == len(bodies)
    for (old, new), body in zip(heads, bodies):
        lines = body.splitlines()
        assert sum(x[:1] in " -" for x in lines) == int(old)
        assert sum(x[:1] in " +" for x in lines) == int(new)


def test_compare_rates_refuses_without_a_card(monkeypatch):
    """tools/compare_rates.py measures on the card only: without one it
    exits 1 before it starts a child."""
    import compare_rates as cr
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["compare_rates.py", ROOT])
    monkeypatch.setattr(cr, "child", None)
    assert cr.main() == 1


def _walked_chains(d, cls, lanes):
    """The class SSE's lane chains past 2^24, walked one by one: (count,
    the longest's blocks, its float32 adds past the exact prefix)."""
    out = [0, 0, 0]
    for lv in range(d.shape[0]):
        for c in range(25):
            for lane in range(lanes):
                chain = [int(d[lv, k]) for k in range(lane, d.shape[1], lanes)
                         if int(cls[k]) == c]
                if sum(chain) <= 2 ** 24:
                    continue
                out[0] += 1
                run, exact = 0, 0
                for v in chain:
                    run += v
                    exact += run <= 2 ** 24
                if len(chain) > out[1]:
                    out[1:] = [len(chain), len(chain) - exact]
    return out


@pytest.mark.parametrize("shape", [(128, 128), (256, 256)],
                         ids=["16-lanes", "8-lanes"])
def test_class_chain_lengths_match_a_walk(shape):
    """chip_smoke.class_chain_lengths (the class SSE's ordered lane chains
    and the longest's length, which set its dependent-add floor) equals a
    walk of every (level, class, lane) chain, on levels whose blocks' SSEs
    are small on the top half and at their maximum below, where most
    blocks are of one class."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from x266_tpu_torch.kernels import alf

    h, w = shape
    rng = np.random.default_rng(w)
    orig = torch.from_numpy(rng.choice([0, 255], (h, w)).astype(np.int32))
    far = torch.arange(h)[None, :, None] >= h // 2
    noise = torch.from_numpy(rng.integers(-3, 4, (2, h, w)))
    filt = torch.where(far, 255 - orig[None], (orig[None] + noise)
                       .clamp(0, 255)).to(torch.uint8)
    cls = torch.from_numpy(rng.choice(25, (h // 4, w // 4),
                                      p=[0.9] + [0.1 / 24] * 24)
                           .astype(np.int32))
    d = alf.block_sse(filt, orig).reshape(2, -1)
    lanes = 16 if d.shape[1] < alf.CLASS_SSE_FUSED else 8
    got = cs.class_chain_lengths(filt, orig, cls)
    want = _walked_chains(d, cls.reshape(-1), lanes)
    assert want[0] > 0 and want[2] < want[1]
    assert [got["ordered_chains"], got["longest_blocks"],
            got["longest_float_adds"]] == want


@pytest.mark.parametrize("cy,cx,adds", [(1, 2, 2), (4, 7, 9), (6, 3, 18),
                                        (17, 30, 93), (34, 60, 363)])
def test_gate_adds_follow_gain_total(cy, cx, adds):
    """chip_smoke.gate_adds: the dependent adds of CC-ALF's gate in
    alf.gain_total's order (raster below 4 rows and at 5-7; lanes of rows
    folded in halves, then the rows after them)."""
    import chip_smoke as cs

    assert cs.gate_adds(cy, cx) == adds


def test_alf_split_edits_apply_once():
    """tools/profile_alf_split.py's edits of csrc/alf.cu (its variants and
    its stamps) each find their anchor exactly once in the package's
    source, so the tool still builds what it names; a missing anchor is
    refused."""
    import profile_alf_split as split

    for edits in (*split.VARIANTS.values(), split.STAMPS):
        text = split.edited(edits)
        for _, new in edits:
            assert new in text
    with pytest.raises(ValueError):
        split.edited([("no such line in alf.cu", "")])
