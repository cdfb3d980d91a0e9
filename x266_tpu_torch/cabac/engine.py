"""Pure-Python mirror of the native range coder (oracle + fallback).

Bit-identical to ``native/rangecoder.cpp``.  Spec (x266t-RC1):

- State: 64-bit ``low``, 32-bit ``range`` (init 0xFFFFFFFF), byte cache with
  carry propagation (LZMA-style ShiftLow), output is a byte stream.
- A context is a 16-bit pair of probability counters (p "probability that
  the next bin is 1", in 1/2^PROB_BITS units); estimation is two-rate:
  fast (shift 4) and slow (shift 7), effective p = (pf + ps) / 2.
- encode_bin(ctx, b): bound = (range >> PROB_BITS) * p; b==1 takes the low
  interval [0, bound), b==0 takes [bound, range).
- bypass bins split the range in half exactly.
- flush() emits 5 ShiftLow()s; the decoder primes 5 bytes (first is 0).

Contexts adapt after coding, so encoder/decoder stay in lockstep.
"""

from __future__ import annotations

import numpy as np

PROB_BITS = 12                      # probability precision of the coder
PROB_MAX = 1 << PROB_BITS
PROB_INIT = PROB_MAX // 2           # p = 0.5
PROB_MIN = 16                       # clamp: keeps 0 < bound < range always
RATE_FAST = 4
RATE_SLOW = 7
TOP = 1 << 24


class ContextSet:
    """An array of adaptive contexts: (n, 2) uint16 [p_fast, p_slow].

    init: optional (n, 2) trained initial states (cabac/ctx_init.py);
    None starts every context at p = 0.5."""

    def __init__(self, n: int, init=None):
        if init is None:
            self.p = np.full((n, 2), PROB_INIT, dtype=np.uint16)
        else:
            assert init.shape == (n, 2)
            self.p = np.array(init, dtype=np.uint16)

    def prob(self, idx: int) -> int:
        """Effective p(bin==1), clamped to (0, 1) exclusive: the counters
        can saturate to 0 after long one-sided runs, and p==0 would give
        bound==0 -> range==0 -> a stuck renorm loop."""
        pf, ps = int(self.p[idx, 0]), int(self.p[idx, 1])
        p = (pf + ps) >> 1
        return min(max(p, PROB_MIN), PROB_MAX - PROB_MIN)

    def update(self, idx: int, bin_val: int) -> None:
        pf, ps = int(self.p[idx, 0]), int(self.p[idx, 1])
        target = PROB_MAX if bin_val else 0
        pf += (target - pf) >> RATE_FAST
        ps += (target - ps) >> RATE_SLOW
        self.p[idx, 0] = pf
        self.p[idx, 1] = ps


class RangeEncoder:
    def __init__(self) -> None:
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1         # matches the leading 0 byte on decode
        self.out = bytearray()

    def _shift_low(self) -> None:
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            for _ in range(self.cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def _renorm(self) -> None:
        while self.range < TOP:
            self._shift_low()
            self.range = (self.range << 8) & 0xFFFFFFFF

    def encode_bin(self, ctxs: ContextSet, idx: int, bin_val: int) -> None:
        p = ctxs.prob(idx)
        bound = (self.range >> PROB_BITS) * p
        if bin_val:
            self.range = bound
        else:
            self.low += bound
            self.range -= bound
        ctxs.update(idx, bin_val)
        self._renorm()

    def encode_bypass(self, bin_val: int) -> None:
        self.range >>= 1
        if not bin_val:
            self.low += self.range
        self._renorm()

    def encode_bypass_bits(self, value: int, nbits: int) -> None:
        for k in range(nbits - 1, -1, -1):
            self.encode_bypass((value >> k) & 1)

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        data = bytes(self.out)
        # The first emitted byte is always 0 (cache init); drop it so the
        # payload carries no dead byte; decoder re-inserts it.
        assert data[0] == 0
        return data[1:]


class RangeDecoder:
    def __init__(self, data: bytes) -> None:
        self._data = b"\x00" + data + b"\x00" * 8  # tolerant tail padding
        self._pos = 1                              # skip re-inserted 0 byte
        self.range = 0xFFFFFFFF
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._data[self._pos]) \
                & 0xFFFFFFFF
            self._pos += 1

    def _renorm(self) -> None:
        while self.range < TOP:
            if self._pos >= len(self._data):
                raise ValueError("truncated entropy payload")
            self.code = ((self.code << 8) | self._data[self._pos]) \
                & 0xFFFFFFFF
            self._pos += 1
            self.range = (self.range << 8) & 0xFFFFFFFF

    def decode_bin(self, ctxs: ContextSet, idx: int) -> int:
        p = ctxs.prob(idx)
        bound = (self.range >> PROB_BITS) * p
        if self.code < bound:
            bin_val = 1
            self.range = bound
        else:
            bin_val = 0
            self.code -= bound
            self.range -= bound
        ctxs.update(idx, bin_val)
        self._renorm()
        return bin_val

    def decode_bypass(self) -> int:
        self.range >>= 1
        if self.code < self.range:
            return_val = 1
        else:
            self.code -= self.range
            return_val = 0
        self._renorm()
        return return_val

    def decode_bypass_bits(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bypass()
        return v

    @property
    def consumed(self) -> int:
        """Bytes consumed from the original payload (approximate tail)."""
        return self._pos - 1
