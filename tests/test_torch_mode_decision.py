"""Pass A of the port against the JAX reference: the size, mode and MTS
maps must be identical (exact equality), including on flat content where
many modes tie (F1: ``jax.lax.top_k`` keeps the lower mode index first
on ties, ``torch.topk`` does not).
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

# the configs of tests/test_torch_recon.py, so the JAX compilations
# (functools-cached in x266_tpu.engine.mode_decision) are shared
CFGS = [
    CodecConfig(width=104, height=72, qp=30),
    CodecConfig(width=104, height=72, qp=30, ref_substitute=True),
    preset_cfg2(128, 64),
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
    if cfg.mts:
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
    f"{'-subst' if c.ref_substitute else ''}"))
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
