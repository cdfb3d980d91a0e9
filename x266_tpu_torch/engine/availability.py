"""Coding-order geometry and reference availability masks, vectorized.

``z_index``, ``z_deinterleave``, ``decoded_before`` and
``valid_block_grid`` are the reference's own (x266_tpu/engine/
availability.py:22-52, 124-130), carried over unchanged.  ``ref_masks``
gives the same tables as the reference's ref_masks (which builds them
block by block in Python, ~20 s for the luma and chroma sizes of a
1080p picture) in one broadcast call of ``decoded_before``.  Masks with
the MTT BT-V order are not in this slice.
"""

from __future__ import annotations

import functools

import numpy as np

CTU = 64
UNIT = 8


def z_index(ux: np.ndarray, uy: np.ndarray) -> np.ndarray:
    """Morton index of 8x8 units within a CTU (3 bits each axis)."""
    ux = np.asarray(ux)
    uy = np.asarray(uy)
    z = np.zeros_like(ux)
    for b in range(3):
        z |= ((ux >> b) & 1) << (2 * b)
        z |= ((uy >> b) & 1) << (2 * b + 1)
    return z


def z_deinterleave(z: int) -> tuple[int, int]:
    """z -> (ux, uy) within-CTU unit coords."""
    ux = ((z >> 0) & 1) | (((z >> 2) & 1) << 1) | (((z >> 4) & 1) << 2)
    uy = ((z >> 1) & 1) | (((z >> 3) & 1) << 1) | (((z >> 5) & 1) << 2)
    return ux, uy


def decoded_before(px: np.ndarray, py: np.ndarray,
                   bx: int | np.ndarray, by: int | np.ndarray,
                   width: int, height: int) -> np.ndarray:
    """Is sample (px, py) reconstructed before the block at origin (bx, by)
    begins decoding?  Vectorized over sample arrays."""
    px, py = np.asarray(px), np.asarray(py)
    bx, by = np.asarray(bx), np.asarray(by)
    inside = (px >= 0) & (py >= 0) & (px < width) & (py < height)
    c_p = (py // CTU) * (1 << 20) + (px // CTU)
    c_b = (by // CTU) * (1 << 20) + (bx // CTU)
    zp = z_index((px % CTU) // UNIT, (py % CTU) // UNIT)
    zb = z_index((bx % CTU) // UNIT, (by % CTU) // UNIT)
    return inside & ((c_p < c_b) | ((c_p == c_b) & (zp < zb)))


@functools.cache
def valid_block_grid(width: int, height: int, size: int) -> np.ndarray:
    """(gy, gx) bool: block fully inside the picture."""
    gy = -(-height // size)
    gx = -(-width // size)
    iy, ix = np.mgrid[0:gy, 0:gx]
    return ((ix + 1) * size <= width) & ((iy + 1) * size <= height)


def ref_masks(width: int, height: int, size: int,
              scale: int = 1) -> np.ndarray:
    """(grid_y, grid_x, 4s+1) bool: is each entry of each size-aligned
    block's [corner, top 2s, left 2s] reference vector reconstructed
    before the block, on the (width/scale, height/scale) plane."""
    s = size
    gy = -(-(height // scale) // s)
    gx = -(-(width // scale) // s)
    y = (np.arange(gy) * s)[:, None, None]
    x = (np.arange(gx) * s)[None, :, None]
    k = np.arange(2 * s)
    px = np.empty((gy, gx, 4 * s + 1), np.int64)
    py = np.empty_like(px)
    px[..., :1], py[..., :1] = x - 1, y - 1                  # corner
    px[..., 1:2 * s + 1], py[..., 1:2 * s + 1] = x + k, y - 1  # top
    px[..., 2 * s + 1:], py[..., 2 * s + 1:] = x - 1, y + k    # left
    bx = np.broadcast_to(x * scale, px.shape)
    by = np.broadcast_to(y * scale, px.shape)
    return decoded_before(px * scale, py * scale, bx, by, width, height)
