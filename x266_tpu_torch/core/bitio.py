"""Bit-level I/O and Exp-Golomb codes (SURVEY.md §2.1 C1) [STD].

MSB-first bit packing, identical to HEVC/VVC RBSP conventions:
``ue(v)``/``se(v)`` Exp-Golomb, ``u(n)`` fixed-width, byte alignment with
``rbsp_trailing_bits`` (a 1 bit then zero padding).  Used for parameter sets
and slice headers; entropy-coded payloads use the range coder in
``x266_tpu.cabac`` instead.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer accumulating into a bytearray."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0          # bit accumulator, MSB-aligned within _nbits
        self._nbits = 0        # number of valid bits in _acc

    def u(self, value: int, nbits: int) -> None:
        """Write ``value`` as ``nbits`` unsigned bits, MSB first."""
        if nbits < 0 or (nbits < 64 and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def flag(self, b: bool | int) -> None:
        self.u(1 if b else 0, 1)

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb: (leading zeros) 1 (value+1 bits) [STD]."""
        if value < 0:
            raise ValueError("ue(v) requires non-negative value")
        v = value + 1
        nbits = v.bit_length()
        self.u(0, nbits - 1)
        self.u(v, nbits)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb: v>0 -> 2v-1, v<=0 -> -2v [STD]."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align(self) -> None:
        """rbsp_trailing_bits(): stop bit 1 then zero-pad to byte [STD]."""
        self.u(1, 1)
        if self._nbits:
            self.u(0, 8 - self._nbits)

    def bytes_value(self) -> bytes:
        if self._nbits:
            raise ValueError("writer not byte-aligned; call align() first")
        return bytes(self._buf)

    @property
    def bit_position(self) -> int:
        return 8 * len(self._buf) + self._nbits


class BitReader:
    """MSB-first bit reader over a bytes object."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def u(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 63:
                raise ValueError("malformed ue(v)")
        return ((1 << zeros) | self.u(zeros)) - 1 if zeros else 0

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def align(self) -> None:
        """Consume rbsp_trailing_bits (stop bit + zero padding)."""
        if self.u(1) != 1:
            raise ValueError("missing rbsp stop bit")
        while self._pos & 7:
            if self.u(1) != 0:
                raise ValueError("nonzero rbsp alignment bit")

    @property
    def bit_position(self) -> int:
        return self._pos

    @property
    def byte_position(self) -> int:
        if self._pos & 7:
            raise ValueError("not byte aligned")
        return self._pos >> 3
