"""The intra tools (lossless, transform skip, PDPC, MIP) on P and B
pictures, against the JAX package: every block's best Pass-A cost bit
for bit (the float32 orders of the inter costs), the P and B Pass-A maps
with the tools on, and the plain P and B recon scans (the oracles of
K3-P and K3-B) on the reference's maps, encode and decode.  Tolerance:
exact equality.

The reference's P and B Pass A run their float32 costs as XLA CPU
compiles them: the rate sums nest in the cost's loop fusion and the
lossy D + lam * R is one fused multiply-add (as intra Pass A's, F12);
the B candidates' transform-domain cost err * (1 / g2) + lam * R is one
too, around the first product; the lossless residual rates sum in the
orders of kernels.cost.rate_inter_residual.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu import config as jconfig
from x266_tpu.engine import fused as jfused
from x266_tpu.engine import inter as jinter
from x266_tpu.engine import mode_decision as jmd
from x266_tpu.kernels import me as jme
from x266_tpu_torch import config as tconfig
from x266_tpu_torch import tables
from x266_tpu_torch.core.yuv import synthetic_clip
from x266_tpu_torch.engine import inter as tinter
from x266_tpu_torch.engine import mode_decision as tmd
from x266_tpu_torch.kernels import me as tme
from x266_tpu_torch.kernels import me_cuda

from tests.test_torch_inter import NAMES, _assert_equal, _t

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

W, H = 128, 64
SIZES = (8, 16, 32)


def _cfgs(b, **kw):
    kw = dict(width=W, height=H, qp=32, intra_period=8,
              gop_size=4 if b else 1, **kw)
    return jconfig.CodecConfig(**kw), tconfig.CodecConfig(**kw)


@functools.lru_cache(maxsize=None)
def _build():
    return jax.jit(lambda a, b, c: jfused._build_pyramids_device(
        a.astype(jnp.int32), b.astype(jnp.int32), c.astype(jnp.int32)))


def _pyramids(y, cb, cr):
    return [np.asarray(p) for p in _build()(y, cb, cr)]


# --- R2: every block's best Pass-A cost --------------------------------

def _jax_costs(jcfg, b):
    """The reference's P or B Pass A up to each size's best cost (its run,
    x266_tpu/engine/inter.py:206-228 and 536-570, without the quadtree),
    jitted: ((best, intra, explicit, skip) per size)."""
    lam = float(jcfg.lambda_mode)

    def run(plane, p0, p1):
        plane = plane.astype(jnp.int32)
        cur = plane[1:1 + H, 1:1 + W]
        g0 = jme.me_search(cur, p0, jcfg, lam)
        g1 = jme.me_search(cur, p1, jcfg, lam) if b else None
        out = []
        for s in SIZES:
            ci, _ = jmd._eval_size(plane, s, jcfg, inter_slice=True)
            if b:
                r = jinter._b_candidates(jcfg, plane, p0, p1, g0, g1, s)
                ce, cs = r[0], r[6]
            else:
                ce, _, _, cs, _ = jinter._inter_cost(jcfg, plane, p0, g0, s)
            valid = jnp.isfinite(ci)
            ce = jnp.where(valid, ce, jnp.inf)
            cs = jnp.where(valid, cs, jnp.inf)
            out.append((jnp.minimum(jnp.minimum(ci, ce), cs), ci, ce, cs))
        return out

    return jax.jit(run)


def _port_costs(tcfg, b, plane, p0, p1):
    tab = tables.from_reference(tcfg, "cpu")
    geom = tmd._Geometry(tcfg, tab.device)
    mvbits = torch.from_numpy(np.load(tinter.MVBITS_PATH))
    plane = plane.to(torch.int32)
    cur = plane[1:1 + H, 1:1 + W]
    lam = float(tcfg.lambda_mode)
    g0 = tme.me_search(cur, p0, tcfg, lam)
    fr0 = me_cuda.warp_frames(p0, tinter.warp_fields(g0, 32))
    warp0 = {8: fr0[0:3], 16: fr0[0:3], 32: fr0[3:6]}
    if b:
        g1 = tme.me_search(cur, p1, tcfg, lam)
        fr1 = me_cuda.warp_frames(p1, torch.stack(
            [g1, tinter._rep2(g1, *g1.shape[:2])]).contiguous())
        warp1 = {8: fr1[0], 16: fr1[0], 32: fr1[1]}
    out = []
    for s in SIZES:
        ci, _, _ = tmd._eval_size(plane, s, tcfg, tab, geom,
                                  inter_slice=True)
        if b:
            g2_inv = torch.tensor(np.float32(1) / np.float32(
                tinter._fwd_gain2(tab, s, 8)))
            r = tinter._b_candidates(tcfg, tab, mvbits, plane, p0, g0, g1,
                                     s, warp0[s], warp1[s], g2_inv)
            ce, cs = r[0], r[6]
        else:
            ce, _, _, cs, _ = tinter._inter_cost(tcfg, tab, mvbits, plane,
                                                 p0, g0, s, warp0[s])
        inf = torch.full_like(ce, float("inf"))
        valid = torch.isfinite(ci)
        ce, cs = torch.where(valid, ce, inf), torch.where(valid, cs, inf)
        out.append((torch.minimum(torch.minimum(ci, ce), cs), ci, ce, cs))
    return out


def _cost_pictures():
    """(current, L0, L1) luma: a scrolled text picture, and full-range
    noise against noisy shifts of itself."""
    text = synthetic_clip(W, H, 2, "text", seed=7)
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (H, W)).astype(np.uint8)

    def near(shift):
        return np.clip(np.roll(noise, shift, (0, 1)).astype(np.int32)
                       + rng.integers(-40, 41, (H, W)), 0, 255
                       ).astype(np.uint8)

    return {"text": (text[1].y, text[0].y, np.roll(text[1].y, 2, 0)),
            "noise": (noise, near((1, -2)), near((-1, 1)))}


@pytest.mark.parametrize("lossless", [False, True],
                         ids=["lossy", "lossless"])
@pytest.mark.parametrize("pic", ["P", "B"])
def test_inter_pass_a_costs_match_jax(pic, lossless):
    """Each size's best cost of every block of P and B Pass A, and its
    intra, explicit and skip parts, bit for bit, on text and on noise.
    Before the port summed the lossy rates in the nested order and
    contracted D + lam * R (and the B candidates' cost), 27 of 128 8x8
    and 6 of 32 16x16 explicit P costs of the text picture differed;
    the lossless rates sum in yet other orders."""
    b = pic == "B"
    kw = dict(lossless=True, rdoq=False) if lossless else {}
    jcfg, tcfg = _cfgs(b, **kw)
    probe = _jax_costs(jcfg, b)
    for name, (cur, r0, r1) in _cost_pictures().items():
        plane = jmd.pad_plane(np.ascontiguousarray(cur)).astype(np.int32)
        p0 = _pyramids(r0, r0[::2, ::2], r0[::2, ::2])[0]
        p1 = _pyramids(r1, r1[::2, ::2], r1[::2, ::2])[0]
        want = probe(plane, p0, p1)
        got = _port_costs(tcfg, b, torch.from_numpy(plane), _t(p0), _t(p1))
        for s, w, g in zip(SIZES, want, got):
            for part, a, c in zip(("best", "intra", "explicit", "skip"),
                                  w, g):
                bad = int((np.asarray(a) != c.numpy()).sum())
                assert bad == 0, f"{name} {s}x{s} {part}: {bad} blocks"


# --- the tools' maps and the plain P and B scans ------------------------

# VVC's intra tools as the tools_ra clip runs them (with MTS: the
# reference's plain inter scan codes transform skip only beside it), and
# lossless
TOOLS = {"lossless": dict(lossless=True, rdoq=False),
         "vvc-tools": dict(profile=jconfig.Profile.VVC, mts=True,
                           pdpc=True, mip=True, transform_skip=True)}


def _tool_picture():
    """'motion' with L0 / L1 its shifts, each noisy (+-40) on two thirds
    of its width, so that intra CUs, MIP and PDPC-class among them, sit
    beside inter ones."""
    f = synthetic_clip(W, H, 1, "motion", seed=9)[0]
    rng = np.random.default_rng(5)

    def ref(shift, cols):
        out = []
        for p in (f.y, f.cb, f.cr):
            sh = shift if p is f.y else (shift[0] // 2, shift[1] // 2)
            q = np.roll(p, sh, (0, 1)).astype(np.int32)
            n = rng.integers(-40, 41, q.shape)
            n[:, cols(q.shape[1])] = 0
            out.append(np.clip(q + n, 0, 255).astype(np.uint8))
        return _pyramids(*out)

    return ((f.y, f.cb, f.cr),
            ref((2, -3), lambda w: slice(2 * w // 3, w)),
            ref((-1, 2), lambda w: slice(0, w // 3)))


@functools.lru_cache(maxsize=None)
def _tool_maps(tool, pic):
    """The JAX Pass-A maps of the tool picture (asserted equal to the
    port's), with the padded planes and pyramids."""
    b = pic == "B"
    jcfg, tcfg = _cfgs(b, **TOOLS[tool])
    planes_raw, p0, p1 = _tool_picture()
    planes = [jmd.pad_plane(p).astype(np.int32) for p in planes_raw]
    tab = tables.from_reference(tcfg, "cpu")
    if b:
        want = jax.jit(jinter.make_mode_decision_b_raw(jcfg))(
            planes[0], p0[0], p1[0])
        got = tinter.make_mode_decision_b_raw(tcfg, tab)(
            _t(planes[0]), _t(p0[0]), _t(p1[0]))
    else:
        want = jax.jit(jinter.make_mode_decision_p_raw(jcfg))(planes[0],
                                                              p0[0])
        got = tinter.make_mode_decision_p_raw(tcfg, tab)(_t(planes[0]),
                                                         _t(p0[0]))
    want = [np.asarray(m) for m in want]
    for n, a, c in zip(["size", "mode", "pred", "mvx", "mvy", "mvx1",
                        "mvy1"], want, got):
        assert np.array_equal(a, c.numpy()), n
    return planes, want, p0, p1


@pytest.mark.parametrize("tool", list(TOOLS))
@pytest.mark.parametrize("pic", ["P", "B"])
def test_tools_pass_a_and_plain_scan_match_jax(pic, tool):
    """P and B Pass-A maps with the tools on equal JAX's (_tool_maps),
    and they use them: lossless pictures code inter and intra CUs and no
    skip, the VVC tools' pictures intra CUs with MIP and PDPC-class
    modes.  Then the plain P or B scan on the JAX maps equals the JAX
    scan, and decoding the reference's levels with its final MVs gives
    its recon again; lossless recon is the source."""
    b = pic == "B"
    planes, maps, p0, p1 = _tool_maps(tool, pic)
    size, mode, pred = maps[:3]
    intra = pred == tinter.PRED_INTRA
    assert intra.any() and (pred != tinter.PRED_INTRA).any()
    if tool == "lossless":
        assert not (pred == tinter.PRED_SKIP).any()
    else:
        assert (intra & (mode >= 67)).any()
        assert (intra & np.isin(mode, [0, 1, 18, 50])).any()
    if b:
        assert (pred >= tinter.PRED_L1).any()
    jcfg, tcfg = _cfgs(b, **TOOLS[tool])
    tab = tables.from_reference(tcfg, "cpu")
    mts = np.zeros_like(size)
    tm = [size, mode, mts, *maps[2:5]]
    jargs = (*tm, *p0) + ((*p1, maps[5], maps[6]) if b else ())
    want = jax.jit(jinter.make_recon_inter_raw(jcfg, True, b_mode=b))(
        *planes, *jargs)

    def targs(m):
        out = [_t(a[None], np.int32) for a in m] + [_t(p) for p in p0]
        if b:
            out += [_t(p) for p in p1] + [_t(a[None], np.int32)
                                          for a in maps[5:7]]
        return out

    scan = functools.partial(tinter.make_recon_inter_raw, tcfg, tab,
                             b_mode=b)
    got = scan(True)(*(_t(p[None], np.uint8) for p in planes), *targs(tm))
    _assert_equal(NAMES, want, got)
    if tool == "lossless":
        for n, a, p in zip(NAMES, want[:3], planes):
            assert np.array_equal(np.asarray(a), p[1:-tmd.PAD, 1:-tmd.PAD]), n
    dm = tm[:4] + [np.asarray(m).astype(np.int32) for m in want[6:]]
    dgot = scan(False)(*(_t(np.asarray(c)[None], np.int16)
                         for c in want[3:6]), *targs(dm))
    _assert_equal(NAMES, want, dgot)
