"""x266-tpu-torch: the PyTorch + CUDA port of the x266-tpu codec.

The JAX package ``x266_tpu`` is the reference; this package reproduces it
bit for bit on an NVIDIA H100, with every Pallas kernel replaced by a
kernel written by hand for Hopper (``csrc/``).  It imports ``torch`` and
neither ``jax`` nor ``x266_tpu``.  The reference's jax-free host layers
are copies here, changed only in their import lines: ``config``, ``core``
(bit I/O, NAL, headers, YUV), ``cabac`` (the native C++ range coder and
syntax walkers), ``specmodel`` (the numpy oracles the tables are built
from), and the coding-order predicates in ``engine.availability``.

Layout mirrors the reference:
    kernels/  transforms, quantization, costs, intra prediction, MC
              interpolation, motion estimation (torch; ME's refine and
              the MC warp as CUDA kernels K5/K4 in me_cuda)
    engine/   Pass A mode decision (I and P), Pass B recon scans (plain
              torch scans + the CUDA kernels K1/K2/K3-P), the fused I and
              P steps, picture glue
    api/      Encoder / Decoder (on the card unless device="cpu")
    csrc/     CUDA C++ sources, built with nvcc on first use (_build.py)

Slice 1 covers all-intra 8-bit encode/decode with the HEVC-subset and
VVC profiles, CU sizes up to 32, MTS, RDOQ and reference substitution;
slice 2 adds low-delay P pictures (skip, merge candidates, AMVP,
signalled reference lists).
"""

__version__ = "0.1.0"
