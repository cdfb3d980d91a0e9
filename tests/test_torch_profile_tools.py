"""tools/profile_recon.py's source handling on the CPU (its measurements
need the card): --split-parent's patching of a parent commit's
recon_intra.cu, and the parts an older source is built from; and
tools/compare_rates.py's refusal without a card."""

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
