"""Pass A of the port against the JAX reference: the size, mode and MTS
maps must be identical (exact equality), including on flat content where
many modes tie (F1: ``jax.lax.top_k`` keeps the lower mode index first
on ties, ``torch.topk`` does not), and with the intra tools: lossless
(the rate of the residual), transform skip (map value 5), PDPC and MIP
(75 candidates through the SAD preselect).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x266_tpu.config import CodecConfig, preset_cfg2
from x266_tpu.core.yuv import synthetic_clip
from x266_tpu.engine import mode_decision as jmd
from x266_tpu_torch import tables
from x266_tpu_torch.engine import mode_decision as tmd

# The tests' tensors are small: intra-op threads gain nothing, and the
# suite's parallel workers would oversubscribe the cores with them.
torch.set_num_threads(1)

# the configs of tests/test_torch_recon.py, so the JAX compilations
# (functools-cached in x266_tpu.engine.mode_decision) are shared
CFGS = [
    CodecConfig(width=104, height=72, qp=30),
    CodecConfig(width=104, height=72, qp=30, ref_substitute=True),
    preset_cfg2(128, 64),
    CodecConfig(width=104, height=72, qp=30, lossless=True),
    CodecConfig(width=104, height=72, qp=30, transform_skip=True),
    preset_cfg2(128, 64).replace(pdpc=True, mip=True, transform_skip=True),
]


def _maps(cfg, y):
    plane = jmd.pad_plane(y).astype(np.int32)
    tplane = tmd.pad_plane(torch.from_numpy(y))
    assert tplane.dtype == torch.uint8
    assert np.array_equal(tplane.numpy(), plane)
    size_j, mode_j = jmd.make_mode_decision(cfg)(plane)
    tab = tables.from_reference(cfg, "cpu")
    size_t, mode_t, res_t = tmd.make_mode_decision_raw(cfg, tab)(tplane)
    assert np.array_equal(np.asarray(size_j), size_t.numpy())
    assert np.array_equal(np.asarray(mode_j), mode_t.numpy())
    if cfg.mts or cfg.transform_skip:
        # the port's MTS stage reuses Pass A's winner residuals, the
        # reference's recomputes them: equal maps check both
        mts_j = jmd.make_mts_select(cfg)(plane, size_j, mode_j)
        mts_t = tmd.make_mts_select_raw(cfg, tab)(
            tplane, size_t, mode_t, res_t)
        assert np.array_equal(np.asarray(mts_j), mts_t.numpy())
    return size_t, mode_t


@pytest.mark.parametrize("kind", ["mixed", "text", "gradient"])
@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: (
    f"{c.width}x{c.height}-{c.profile.name}"
    f"{'-subst' if c.ref_substitute else ''}{'-ll' if c.lossless else ''}"
    f"{'-pdpc-mip' if c.mip else ''}{'-ts' if c.transform_skip else ''}"))
def test_maps_match_jax(cfg, kind):
    y = synthetic_clip(cfg.width, cfg.height, 1, kind, seed=4)[0].y
    _maps(cfg, y)


def test_flat_picture_ties_match_jax():
    """A flat picture with one textured corner: every mode of most
    blocks predicts the same samples, so the SAD preselect and the RD
    argmin are decided by the tie rules alone."""
    cfg = preset_cfg2(128, 64)
    y = np.full((64, 128), 100, np.uint8)
    y[:16, :16] = np.random.default_rng(0).integers(0, 256, (16, 16))
    size_map, mode_map = _maps(cfg, y)
    assert (mode_map == 0).any()


def test_stable_sort_is_top_k_order():
    sad = np.array([[5, 1, 1, 1, 3, 1, 1, 2, 1, 1, 1, 1]], np.float32)
    want = np.asarray(jax.lax.top_k(-jnp.asarray(sad), 5)[1])
    got = torch.sort(torch.from_numpy(sad), dim=1,
                     stable=True).indices[:, :5]
    assert np.array_equal(want, got.numpy())
    assert want.tolist() == [[1, 2, 3, 5, 6]]


def test_pass_a_costs_match_jax():
    """Each size's best RD cost per block, bit for bit (cfg2t's tools on:
    the costs are config 2's plus PDPC's and MIP's candidates): XLA
    nests the rate sums in the argmin's loop fusion (row_vector_sum's
    order) and contracts D + lam * R into one fused multiply-add; on
    text, where rates are high and transposed residuals tie in other
    orders, and on noise."""
    from x266_tpu_torch import config as tconfig
    from x266_tpu_torch.core.yuv import synthetic_clip as tclip

    w, h = 128, 64
    kw = dict(pdpc=True, mip=True, transform_skip=True)
    cfg = preset_cfg2(w, h).replace(**kw)
    tcfg = tconfig.preset_cfg2(w, h).replace(**kw)
    tab = tables.from_reference(tcfg, "cpu")
    geom = tmd._Geometry(tcfg, tab.device)
    text = tclip(w, h, 1, "text", seed=7)[0].y
    noise = np.random.default_rng(0).integers(0, 256, (h, w)).astype(
        np.uint8)
    for y in (text, noise):
        plane = jmd.pad_plane(np.ascontiguousarray(y)).astype(np.int32)
        for s in (8, 16, 32):
            c_j, m_j = (np.asarray(a) for a in jax.jit(
                lambda p: jmd._eval_size(p, s, cfg))(plane))
            c_t, m_t, _ = tmd._eval_size(torch.from_numpy(plane), s, tcfg,
                                         tab, geom)
            assert np.array_equal(c_j, c_t.numpy())
            assert np.array_equal(m_j, m_t.numpy())
