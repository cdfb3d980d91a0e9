"""T2 entropy layer: context-modeled adaptive binary range coding.

The reference's CABAC (C3/C4, SURVEY.md §2.1) is a serial bit-sequential
state machine — the one codec component that cannot be a data-parallel TPU
kernel (SURVEY.md §1.1).  Here it is native C++ (the reference's entropy
layer is native C [B:5]; a Python stand-in would betray the design), with a
bit-identical pure-Python mirror used as the differential-test oracle and
as a fallback when no C++ toolchain exists.

Engine: byte-oriented adaptive binary range coder (LZMA-class renorm/carry
scheme) with per-context two-rate probability estimation (VVC-flavored).
The x266t format is self-defined: HEVC/VVC table conformance cannot be
verified in this environment (SURVEY.md §0); encoder and decoder share one
implementation, so round-trip bit-exactness holds by construction and is
enforced by tests.

Parallelism: per-CTU-row segments are independent range-coder streams
stitched on host via slice-header entry points (BASELINE.json:5, P6).
"""

from x266_tpu_torch.cabac.engine import (RangeDecoder, RangeEncoder,  # noqa: F401
                                   PROB_BITS, PROB_INIT)
