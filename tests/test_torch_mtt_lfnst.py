"""MTT binary splits and LFNST of the port against the JAX reference, on
the CPU, every case bit-equal (exact integer and float32 equality):

- kernels/lfnst.py's lfnst_fwd / lfnst_inv against x266_tpu's, on every
  mode of the 35-, 67- and 75-mode (MIP) alphabets (all four sets, both
  transposes), lfnst_idx 0, 1 and 2, at TU sizes 4 to 32, on random and
  extreme (+-32767, -32768) coefficients;
- engine/availability.py's ref_masks with the BT-V order, luma and
  chroma, at 16 and 32 leaves, on pictures whose right and bottom edges
  cut leaves;
- Pass A: _eval_pair's costs and modes, both directions, t = 8 and 16,
  with _eval_size's at the same t, against a jitted probe that composes
  them as the reference's MTT Pass A does (XLA shares their prediction
  prefix); the MTT maps (size, mode, bt) and the MTS select with LFNST on
  them, on several clips, seeds and tool sets;
- the plain scan, encode and decode, at 136x136 against the live XLA scan
  (x266_tpu/engine/recon.py make_recon_pass_raw) on maps that hold BT-H
  and BT-V leaves of 16 and 32 and TUs of both LFNST kernels, beside
  transform skip and MIP, and without substitution;
- the Encoder and Decoder on three 128x64 clips against the JAX streams of
  data/mttlfnst128x64_ref.json: config 2 with MTT and LFNST, the quality
  preset (MTT + SDH), and a low-delay clip with deblock, I then P
  pictures.
"""

import base64
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.config import preset_cfg2 as jpreset_cfg2
from x266_tpu.engine import availability as javail
from x266_tpu.engine import mode_decision as jmd
from x266_tpu.engine import recon as jrec
from x266_tpu.kernels import lfnst as jlfnst
from x266_tpu_torch import tables
from x266_tpu_torch.api import Decoder, Encoder
from x266_tpu_torch.config import (Profile, preset_cfg2, preset_cfg2q,
                                   preset_cfg3)
from x266_tpu_torch.core.hashing import frame_md5
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.engine import availability, fused, recon
from x266_tpu_torch.engine import mode_decision as tmd
from x266_tpu_torch.kernels import lfnst

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

W, H = 128, 64
DATA = os.path.join(os.path.dirname(__file__), "..", "x266_tpu_torch",
                    "data")
# the configs' tools (on top of preset_cfg2): both tools; both with
# VVC's intra tools (MIP's alphabet in LFNST's classes, transform skip
# and MTS beside LFNST); both under DQ without substitution (the scan's
# mid-gray then gives the BT-V order's availability); the quality
# preset's MTT + SDH
TOOLS = {
    "mtt-lfnst": dict(mtt=True, lfnst=True),
    "mtt-lfnst-tools": dict(mtt=True, lfnst=True, pdpc=True, mip=True,
                            transform_skip=True),
    "mtt-lfnst-dq-nosubst": dict(mtt=True, lfnst=True, dep_quant=True,
                                 ref_substitute=False),
    "mtt-sdh": dict(mtt=True, sign_data_hiding=True),
}


def _counts(size_map, mts_map) -> dict:
    """Units of BT-H and BT-V leaves of 16 and 32 and TUs' units with
    LFNST kernel 1 and 2 of (..., H/8, W/8) maps."""
    size_map, mts_map = np.asarray(size_map), np.asarray(mts_map)
    bt, lf = (mts_map >> 4) & 3, (mts_map >> 6) & 3
    out = {f"bt{b}@{s}": int(((bt == b) & (size_map == s)).sum())
           for b in (1, 2) for s in (16, 32)}
    out.update({f"lfnst{k}": int((lf == k).sum()) for k in (1, 2)})
    return out


# ---- LFNST ----------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n_modes", [35, 67, 75])
def test_lfnst_matches_jax(n_modes, inverse):
    rng = np.random.default_rng(n_modes)
    fj = jlfnst.lfnst_inv if inverse else jlfnst.lfnst_fwd
    ft = lfnst.lfnst_inv if inverse else lfnst.lfnst_fwd
    modes = np.repeat(np.arange(n_modes, dtype=np.int32), 3)
    idx = np.tile(np.arange(3, dtype=np.int32), n_modes)
    for s in (4, 8, 16, 32):
        coef = rng.integers(-32768, 32768, (modes.size, s, s)).astype(
            np.int32)
        coef[::5] = 32767
        coef[1::5] = -32768
        coef[2::5, :4, :4] = rng.choice([-32768, 32767], (4, 4))
        want = np.asarray(fj(jnp.asarray(coef), jnp.asarray(modes),
                             jnp.asarray(idx), n_modes))
        got = ft(torch.from_numpy(coef), torch.from_numpy(modes),
                 torch.from_numpy(idx), n_modes).numpy()
        assert np.array_equal(want, got), s
    sj, tj = jlfnst.mode_class(jnp.arange(n_modes), n_modes)
    st, tt = lfnst.mode_class(torch.arange(n_modes), n_modes)
    assert np.array_equal(np.asarray(sj), st.numpy())
    assert np.array_equal(np.asarray(tj), tt.numpy())
    assert set(st.tolist()) == {0, 1, 2, 3} and tt.any() and not tt.all()


# ---- availability ---------------------------------------------------------

@pytest.mark.parametrize("wh", [(128, 64), (136, 136), (200, 104)])
def test_btv_masks_match_jax(wh):
    """The BT-V order's masks of t-TUs in leaves of 16 and 32, luma and
    chroma (the scan's tabLv / tabCv), and the z-order masks beside
    them; 136 and 200 end in partial leaves."""
    w, h = wh
    for s, scale, leaf in ((8, 1, 16), (16, 1, 32), (4, 2, 8), (8, 2, 16),
                           (8, 1, 0), (16, 2, 0)):
        want = javail.ref_masks(w, h, s, scale=scale, btv_leaf=leaf)
        got = availability.ref_masks(w, h, s, scale, leaf)
        assert np.array_equal(want, got), (s, scale, leaf)
        if leaf:
            assert not np.array_equal(got, availability.ref_masks(
                w, h, s, scale))


# ---- Pass A ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_probe():
    """The reference's _eval_size and both _eval_pair directions at t = 8
    and 16 (and _eval_size at 32) in one jit, as its MTT Pass A composes
    them."""
    cfg = jpreset_cfg2(W, H).replace(mtt=True, lfnst=True)

    def probe(plane):
        out = []
        for s in (8, 16, 32):
            out.append(jmd._eval_size(plane, s, cfg))
            if s < 32:
                out += [jmd._eval_pair(plane, s, cfg, vertical=False),
                        jmd._eval_pair(plane, s, cfg, vertical=True)]
        return out

    return jax.jit(probe)


@pytest.mark.parametrize("kind", ["text", "noise"])
def test_pass_a_pair_costs_match_jax(kind, pair_probe):
    """Every pair's best cost and shared mode, both directions, bit for
    bit: the RD chain's rate sums in row_vector_sum's order and D + lam *
    R as one fused multiply-add (F12's order), then (rd0 + rd1) + lam *
    (MODE_SIGNAL_BITS + 2); _eval_size's costs keep F12's order in the
    same jit."""
    cfg = preset_cfg2(W, H).replace(mtt=True, lfnst=True)
    tab = tables.from_reference(cfg, "cpu")
    geom = tmd._Geometry(cfg, tab.device)
    if kind == "text":
        y = synthetic_clip(W, H, 1, "text", seed=7)[0].y
    else:
        y = np.random.default_rng(0).integers(0, 256, (H, W)).astype(
            np.uint8)
    plane = jmd.pad_plane(np.ascontiguousarray(y)).astype(np.int32)
    want = pair_probe(plane)
    got = []
    for s in (8, 16, 32):
        pred = tmd._predict(torch.from_numpy(plane), s, cfg, tab, geom)
        got.append(tmd._eval_size(None, s, cfg, tab, geom, pred=pred)[:2])
        if s < 32:
            got += [tmd._eval_pair(pred, s, cfg, tab, geom, False),
                    tmd._eval_pair(pred, s, cfg, tab, geom, True)]
    for i, (wj, gt) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(wj[0]), gt[0].numpy()), i
        assert np.array_equal(np.asarray(wj[1]), gt[1].numpy()), i


@pytest.fixture(scope="module")
def jax_pass_a():
    """{(tools, w, h): jitted reference Pass A and MTS select}."""
    cache = {}

    def get(name, w, h):
        if (name, w, h) not in cache:
            cfg = jpreset_cfg2(w, h).replace(**TOOLS[name])
            cache[name, w, h] = (
                jax.jit(jmd.make_mode_decision_raw(cfg)),
                jax.jit(jmd.make_mts_select_raw(cfg)))
        return cache[name, w, h]

    return get


def _port_maps(cfg, y):
    """The port's Pass A and MTS select on one frame: (size, mode, bt,
    mts) int32."""
    tab = tables.from_reference(cfg, "cpu")
    plane = tmd.pad_plane(torch.from_numpy(np.ascontiguousarray(y)))
    size_map, mode_map, bt = tmd.make_mode_decision_raw(cfg, tab)(plane)
    mts = tmd.make_mts_select_raw(cfg, tab)(plane, size_map, mode_map,
                                            bt_map=bt)
    return size_map, mode_map, bt, mts


@pytest.mark.parametrize("name,wh,kind,seed", [
    ("mtt-lfnst", (128, 64), "text", 10),
    ("mtt-lfnst", (128, 64), "mixed", 2),
    ("mtt-lfnst", (128, 64), "motion", 4),
    ("mtt-lfnst", (128, 64), "gradient", 0),
    ("mtt-lfnst", (112, 80), "text", 3),
    ("mtt-lfnst-tools", (128, 64), "text", 10),
    ("mtt-lfnst-tools", (128, 64), "motion", 6),
    ("mtt-sdh", (128, 64), "mixed", 77),
])
def test_mtt_pass_a_maps_match_jax(name, wh, kind, seed, jax_pass_a):
    """The MTT Pass A maps (size, mode, bt) and the MTS select with LFNST
    on them (at each unit's effective TU size, the blocks predicted anew
    with mode_map's modes): 112x80 has pair grids that the leaf grid
    pads."""
    w, h = wh
    cfg = preset_cfg2(w, h).replace(**TOOLS[name])
    y = synthetic_clip(w, h, 1, kind, seed=seed)[0].y
    md, ms = jax_pass_a(name, w, h)
    plane = jmd.pad_plane(y).astype(np.int32)
    sj, mj, bj = md(plane)
    mtsj = ms(plane, sj, mj, bj, None)
    got = _port_maps(cfg, y)
    for n, a, b in zip(("size", "mode", "bt", "mts"), (sj, mj, bj, mtsj),
                       got):
        assert np.array_equal(np.asarray(a), b.numpy()), n
    assert (got[2] > 0).any()


# ---- the plain scan -------------------------------------------------------

SCANS = {   # tools on top of preset_cfg2, clip kind and seed at 136x136
    "mtt-lfnst": (dict(mtt=True, lfnst=True), "text", 3),
    # transform skip and MTS beside LFNST, PDPC
    "mtt-lfnst-ts": (dict(mtt=True, lfnst=True, pdpc=True,
                          transform_skip=True), "text", 3),
    # MIP's modes in LFNST's classes
    "mtt-lfnst-mip": (dict(mtt=True, lfnst=True, pdpc=True, mip=True),
                      "motion", 6),
    # without substitution the scan's mid-gray gives the BT-V order's
    # availability
    "mtt-lfnst-nosubst": (dict(mtt=True, lfnst=True, ref_substitute=False),
                          "text", 3),
}


@pytest.mark.parametrize("name", list(SCANS))
def test_plain_scan_matches_live_jax(name):
    """The port's plain scan, encode and decode, against the reference's
    XLA scan on the same maps, on a 3x3-CTU picture (136x136: the last
    CTU row and column partial) whose maps hold BT-H and BT-V leaves of
    16 and 32 and TUs of both LFNST kernels (asserted)."""
    tools, kind, seed = SCANS[name]
    w = h = 136
    cfg = preset_cfg2(w, h).replace(**tools)
    jcfg = jpreset_cfg2(w, h).replace(**tools)
    fr = synthetic_clip(w, h, 1, kind, seed=seed)[0]
    size_map, mode_map, bt, mts = _port_maps(cfg, fr.y)
    mts = mts | (bt << 4)
    cnt = _counts(size_map, mts)
    assert all(v > 0 for v in cnt.values()), cnt
    if cfg.mip:
        assert (mode_map >= cfg.n_intra_modes).any()
    if cfg.transform_skip:
        assert ((mts & 7) == 5).any()
    planes = [jmd.pad_plane(getattr(fr, p)).astype(np.int32)
              for p in ("y", "cb", "cr")]
    maps = [m.numpy() for m in (size_map, mode_map, mts)]
    want = [np.asarray(o) for o in jax.jit(
        jrec.make_recon_pass_raw(jcfg, True))(*planes, *maps)]
    dec = [np.asarray(o) for o in jax.jit(
        jrec.make_recon_pass_raw(jcfg, False))(*want[3:], *maps)]
    tab = tables.from_reference(cfg, "cpu")
    tmaps = [torch.from_numpy(m)[None] for m in maps]
    got = recon.make_recon_pass_raw(cfg, tab, True)(
        *(torch.from_numpy(p)[None].to(torch.uint8) for p in planes),
        *tmaps)
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(a, b[0].numpy()), i
    tdec = recon.make_recon_pass_raw(cfg, tab, False)(*got[3:], *tmaps)
    for i, (a, b) in enumerate(zip(dec[:3], tdec[:3])):
        assert np.array_equal(a, b[0].numpy()), i


# ---- streams --------------------------------------------------------------

def _ref():
    with open(os.path.join(DATA, "mttlfnst128x64_ref.json")) as f:
        return json.load(f)["variants"]


CLIPS = {   # data/mttlfnst128x64_ref.json's variants
    "ai_text": (lambda: preset_cfg2(W, H).replace(mtt=True, lfnst=True),
                "text", 2, 10),
    "ai_q": (lambda: preset_cfg2q(W, H), "mixed", 1, 2),
    "ld": (lambda: preset_cfg3(W, H).replace(
        profile=Profile.VVC, mtt=True, lfnst=True, deblock=True,
        intra_period=4), "motion", 3, 4),
}


@pytest.mark.parametrize("name", list(CLIPS))
def test_clip_matches_recorded_jax(name):
    """The Encoder's stream, recon and SSE on the CPU equal the JAX
    encoder's, and the Decoder gives the JAX decoder's MD5s.  ai_text's I
    pictures hold BT-H and BT-V leaves of 16 and 32 and both LFNST
    kernels; ld's I picture BT leaves, so its deblock runs on the TU grid
    (which differs from the CU grid there), and its P pictures code
    neither tool."""
    make_cfg, kind, n, seed = CLIPS[name]
    cfg = make_cfg()
    ref = _ref()[name]
    frames = synthetic_clip(W, H, n, kind, seed=seed)
    res = Encoder(cfg, device="cpu").encode(frames)
    assert res.bitstream == base64.b64decode(ref["stream_b64"])
    assert [frame_md5(r) for r in res.recon] == [
        f["recon_md5"] for f in ref["frames"]]
    assert [[float(v) for v in np.asarray(e)[:3]] for e in res.sse] == [
        f["sse"] for f in ref["frames"]]
    _, dec = Decoder(device="cpu").decode(res.bitstream)
    assert [frame_md5(d) for d in dec] == [f["decode_md5"]
                                           for f in ref["frames"]]
    tab = tables.from_reference(cfg, "cpu")
    y = torch.from_numpy(frames[0].y[None].copy())
    size_map, _, mts = fused.make_pass_a(cfg, tab)(tmd.pad_plane(y))
    cnt = _counts(size_map, mts)
    if name == "ai_text":
        assert all(v > 0 for v in cnt.values()), cnt
    else:
        assert sum(cnt[f"bt{b}@{s}"] for b in (1, 2) for s in (16, 32)) > 0
    if name == "ld":
        assert not torch.equal(fused.tu_size_map(cfg, size_map, mts),
                               size_map)
