"""Reconstruction hashing (SURVEY.md §4: decoded-picture MD5) [STD].

MD5 over the planar samples of a picture, plane by plane (Y, Cb, Cr), the
same shape of check as HEVC/VVC's decoded-picture-hash SEI [STD]. Used as
the encode->decode bit-exactness gate.
"""

from __future__ import annotations

import hashlib

import numpy as np

from x266_tpu_torch.core.yuv import Frame


def frame_md5(frame: Frame) -> str:
    h = hashlib.md5()
    h.update(np.ascontiguousarray(frame.y, dtype=np.uint8).tobytes())
    h.update(np.ascontiguousarray(frame.cb, dtype=np.uint8).tobytes())
    h.update(np.ascontiguousarray(frame.cr, dtype=np.uint8).tobytes())
    return h.hexdigest()


def clip_md5(frames: list[Frame]) -> str:
    h = hashlib.md5()
    for fr in frames:
        h.update(frame_md5(fr).encode())
    return h.hexdigest()
