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
