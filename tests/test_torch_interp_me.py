"""MC interpolation and motion estimation of the port against the JAX
package: the pyramid, the MC block gather, plain K4 (warp_frames_ref)
against the Pallas warp kernel in interpret mode, the integer and coarse
searches, plain K5 (refine_search_ref) against the reference's plain
refine, and me_search.

Plain K5 meets the Pallas refine kernel through the reference's plain
refine: it is compared on the inputs of tests/test_me_pallas.py:48-63,
where the JAX suite holds the Pallas kernel (interpret mode) equal to
that plain refine.  Running the interpret mode here as well would cost
about two minutes of tracing and compiling on the CPU.

Same numpy inputs (seeded) through both; tolerance: exact equality (all
of these are integer gathers and integer SADs, and the float32 search
costs are built in the reference's operation order).  The shapes are
those of tests/test_me_pallas.py (160x96, 112x80), so the JAX
compilations are shared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.config import CodecConfig
from x266_tpu.kernels import interp as jinterp
from x266_tpu.kernels import me as jme
from x266_tpu.kernels.me_pallas import warp_frames
from x266_tpu_torch.kernels import interp as tinterp
from x266_tpu_torch.kernels import me as tme
from x266_tpu_torch.kernels import me_cuda

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)


def _pyr(w, h, seed):
    """A random picture and its luma pyramid, as tests/test_me_pallas.py
    builds them; returns (jax pyramid, torch pyramid, picture)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    pj = jax.jit(lambda p: jinterp.build_pyramid(jinterp.pad_ref(p)))(
        jnp.asarray(y))
    return pj, torch.from_numpy(np.asarray(pj)), y


def _cur(y, seed):
    """The picture shifted by (1, -2) plus noise: ME finds real motion."""
    rng = np.random.default_rng(seed)
    return np.clip(np.roll(y, (1, -2), (0, 1))
                   + rng.integers(-9, 10, y.shape), 0, 255).astype(np.int32)


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_pyramid_and_mc_block_match_jax(chroma):
    w, h = 112, 72              # not a multiple of 16: the ceil-pad case
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    pj = np.asarray(jax.jit(lambda p: jinterp.build_pyramid(
        jinterp.pad_ref(p), chroma))(jnp.asarray(y)))
    pt = tinterp.build_pyramid(tinterp.pad_ref(torch.from_numpy(y)), chroma)
    assert pt.dtype == torch.uint8
    assert np.array_equal(pj, pt.numpy())
    for x0, y0, mx, my, s in ((0, 0, -288, -288, 16), (96, 56, 287, 286, 16),
                              (40, 24, 5, -7, 8), (64, 32, -1, 2, 32)):
        want = np.asarray(jinterp.mc_block(jnp.asarray(pj), x0, y0, mx, my,
                                           s))
        got = tinterp.mc_block(pt, x0, y0, mx, my, s)
        assert np.array_equal(want, got.numpy()), (x0, y0, mx, my, s)


def test_plain_warp_matches_pallas_interpret():
    w, h = 160, 96
    pj, pt, _ = _pyr(w, h, 1)
    by, bx = h // 16, w // 16
    mvs = np.random.default_rng(2).integers(-64, 65, (3, by, bx, 2)).astype(
        np.int32)
    want = np.asarray(warp_frames(pj, jnp.asarray(mvs), h, w))
    got = me_cuda.warp_frames_ref(pt, torch.from_numpy(mvs))
    assert got.shape == (3, h, w) and got.dtype == torch.int32
    assert np.array_equal(want[:, :h, :w], got.numpy())
    assert torch.equal(me_cuda.warp_frames(pt, torch.from_numpy(mvs)), got)


def test_searches_match_jax():
    w, h = 112, 80
    pj, pt, y = _pyr(w, h, 5)
    cur = _cur(y, 6)
    cfg = CodecConfig(width=w, height=h, qp=31, intra_period=8)
    lam = float(cfg.lambda_mode)
    cj = jnp.asarray(cur)
    ct = torch.from_numpy(cur)
    ref = np.asarray(pj[0]).astype(np.int32)
    want = np.asarray(jme.integer_search(cj, jnp.asarray(ref), lam,
                                         radius=4))
    got = tme.integer_search(ct, torch.from_numpy(ref), lam, radius=4)
    assert np.array_equal(want, got.numpy())
    want = np.asarray(jme.coarse_search(cj, pj, lam))
    got = tme.coarse_search(ct, pt, lam)
    assert np.array_equal(want, got.numpy())
    assert np.abs(want).max() > 0
    want = np.asarray(jme.me_search(cj, pj, cfg, lam, use_pallas=False))
    got = tme.me_search(ct, pt, cfg, lam)
    assert np.array_equal(want, got.numpy())


def test_plain_refine_matches_reference():
    """The inputs of tests/test_me_pallas.py:48-63."""
    w, h = 160, 96
    pj, pt, y = _pyr(w, h, 3)
    rng = np.random.default_rng(4)
    cur = np.clip(np.roll(y, (1, -2), (0, 1))
                  + rng.integers(-9, 10, (h, w)), 0, 255).astype(np.int32)
    base = rng.integers(-10, 11, (h // 16, w // 16, 2)).astype(np.int32)
    a = np.asarray(jme.refine_search_ref(jnp.asarray(cur), pj,
                                         jnp.asarray(base)))
    got = tme.refine_search_ref(torch.from_numpy(cur), pt,
                                torch.from_numpy(base)).numpy()
    assert np.array_equal(a, got)
    assert (got % 4 != 0).any()              # quarter-pel winners too


def test_me_block_reads_past_the_pyramid_raise():
    _, pt, y = _pyr(112, 80, 8)
    with pytest.raises(AssertionError):
        tinterp.mc_block(pt, 0, 0, -4 * 81, 0, 16)
    mvs = torch.full((1, 5, 7, 2), 4 * 81, dtype=torch.int32)
    with pytest.raises(AssertionError):
        me_cuda.warp_frames_ref(pt, mvs)
