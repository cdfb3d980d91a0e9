"""Reference availability masks, vectorized.

The same tables as x266_tpu.engine.availability.ref_masks (which builds
them block by block in Python, ~20 s for the luma and chroma sizes of a
1080p picture) computed in one broadcast call of its ``decoded_before``
predicate.  Masks with the MTT BT-V order are not in this slice.
"""

from __future__ import annotations

import numpy as np

from x266_tpu.engine.availability import decoded_before


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
