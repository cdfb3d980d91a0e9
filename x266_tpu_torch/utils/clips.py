"""Test clips derived from the synthetic ones (core.yuv.synthetic_clip)."""

import numpy as np


def luma_chroma(frames):
    """Each frame with its chroma planes made from its luma: s the 2x2
    mean of the luma, Cb = 128 + (s - 128) / 2 and Cr = 128 - (s - 128) /
    2 (floored), clipped to 8 bits; frames of the type given.  The
    synthetic clips' chroma is a gradient that owes nothing to the luma,
    so CC-ALF's whole-filter gate keeps no CTB of them; with chroma made
    from the luma, as camera content's is, CC-ALF turns on."""
    out = []
    for f in frames:
        y = f.y.astype(np.int32)
        s = (y[0::2, 0::2] + y[1::2, 0::2] + y[0::2, 1::2] + y[1::2, 1::2]
             + 2) >> 2
        cb = np.clip(128 + (s - 128) // 2, 0, 255).astype(np.uint8)
        cr = np.clip(128 - (s - 128) // 2, 0, 255).astype(np.uint8)
        out.append(type(f)(f.y, cb, cr))
    return out


def smooth_blocks(frames, seed: int = 0):
    """Each frame with its luma replaced by smooth directional ramps, one
    to each 64x64 block (a seeded angle, slope and level, a slow ripple
    along the ramp and +-2 of noise), with steps between the blocks:
    content on which 64x64 CUs win, under angular modes as well as planar
    and DC; frames of the type given, chroma kept."""
    rng = np.random.default_rng(seed)
    out = []
    for t, f in enumerate(frames):
        h, w = f.y.shape
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        y = np.zeros((h, w))
        for by in range(0, h, 64):
            for bx in range(0, w, 64):
                th = rng.uniform(0, np.pi)
                slope = rng.uniform(0.3, 1.5)
                level = rng.uniform(60, 190)
                u = (xx - bx) * np.cos(th) + (yy - by) * np.sin(th)
                blk = level + slope * (u - 32) + 6 * np.sin(u / 9 + t)
                y[by:by + 64, bx:bx + 64] = blk[by:by + 64, bx:bx + 64]
        y += rng.integers(-2, 3, (h, w))
        out.append(type(f)(np.clip(np.rint(y), 0, 255).astype(np.uint8),
                           f.cb, f.cr))
    return out
