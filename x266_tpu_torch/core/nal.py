"""NAL unit framing with RBSP emulation prevention (SURVEY.md §2.1 C1) [STD].

Annex-B style bytestream: each NAL is ``00 00 00 01`` start code, a one-byte
header carrying the NAL type, then the RBSP payload with emulation
prevention: any ``00 00 0x`` (x in {0,1,2,3}) in the payload gets an
``03`` byte inserted after the two zeros, exactly as in H.265/H.266 [STD].
"""

from __future__ import annotations

from enum import IntEnum


class NalType(IntEnum):
    VPS = 0          # video parameter set (C2, round-5)
    SPS = 1
    PPS = 2
    IDR = 3          # intra random access picture slice
    TRAIL = 4        # non-IDR slice
    EOS = 5


START_CODE = b"\x00\x00\x00\x01"


def escape_rbsp(payload: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes [STD]."""
    out = bytearray()
    zeros = 0
    for b in payload:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def unescape_rbsp(data: bytes) -> bytes:
    """Remove emulation-prevention 0x03 bytes [STD]."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 < n and data[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def write_nal(nal_type: NalType, rbsp: bytes) -> bytes:
    """Frame one NAL.  Contract [STD rbsp_trailing_bits]: the RBSP must be
    non-empty and must not end with 0x00, otherwise the payload boundary is
    ambiguous against the next start code.  Header RBSPs end with the
    align() stop-bit byte; slice payloads append a 0x80 trailing byte.
    """
    if not rbsp or rbsp[-1] == 0:
        raise ValueError("RBSP must be non-empty and not end with 0x00")
    header = bytes([int(nal_type) & 0x3F])
    return START_CODE + header + escape_rbsp(rbsp)


def split_nals(stream: bytes) -> list[tuple[NalType, bytes]]:
    """Split an Annex-B stream into (type, rbsp) tuples."""
    nals: list[tuple[NalType, bytes]] = []
    # Find start codes (both 3- and 4-byte forms accepted on read).
    i = 0
    starts: list[int] = []
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j + 3)
        i = j + 3
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else len(stream)
        # Strip zeros belonging to a 4-byte start code / trailing padding;
        # safe because RBSPs never end with 0x00 (write_nal contract).
        while e > s and stream[e - 1] == 0:
            e -= 1
        nal = stream[s:e]
        if not nal:
            continue
        nals.append((NalType(nal[0] & 0x3F), unescape_rbsp(nal[1:])))
    return nals
