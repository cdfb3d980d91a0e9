"""x266-tpu-torch: the PyTorch + CUDA port of the x266-tpu codec.

The JAX package ``x266_tpu`` is the reference; this package reproduces it
bit for bit on an NVIDIA H100, with every Pallas kernel replaced by a
kernel written by hand for Hopper (``csrc/``).  It imports ``torch`` and
never ``jax``.  The jax-free host layers of the reference are reused as
they are: ``x266_tpu.config``, ``core`` (bit I/O, NAL, headers, YUV),
``cabac`` (the native C++ range coder and syntax walkers), ``specmodel``
(the numpy oracles the tables are built from) and
``engine.availability``.

Layout mirrors the reference:
    kernels/  transforms, quantization, costs, intra prediction (torch)
    engine/   Pass A mode decision, Pass B recon scan (plain torch scan +
              the CUDA kernel K1/K2), the fused I step, picture glue
    api/      Encoder / Decoder (explicit ``device=``)
    csrc/     CUDA C++ sources, built with nvcc on first use (_build.py)

Slice 1 covers all-intra 8-bit encode/decode with the HEVC-subset and
VVC profiles, CU sizes up to 32, MTS, RDOQ and reference substitution.
"""

__version__ = "0.1.0"
