"""T0 host-side core: bit I/O, NAL framing, headers, YUV I/O, hashing."""
