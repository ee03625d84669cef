"""Keccak-256 Fiat-Shamir transcript variant.

Copied from the JAX package's `transcript/keccak.py` (host code, logic
unchanged).

Analog of the reference's `KeccakTranscript`
(`crates/jolt-transcript/src/lib.rs:61-64`: spongefish duplex sponge over
Keccak-f[1600]).  Here the permutation backs a Keccak-256 digest (the
Ethereum variant: pad10*1 with 0x01 domain byte, rate 1088) driving the
same chained-digest framing as the Blake2b transcript -- so every absorb /
challenge rule is shared and the hash function is the only swap
(`Transcript` trait default methods).

Keccak-f[1600] implemented from the FIPS-202 specification (public
algorithm); equivalence-tested against hashlib's SHA3 core by checking
known Keccak-256 vectors in tests/test_transcript.py.
"""

from __future__ import annotations

from .blake2b import Blake2bTranscript

_ROT = [[0, 36, 3, 41, 18],
        [1, 44, 10, 45, 2],
        [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14]]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(lanes):
    """One Keccak-f[1600] permutation on a 5x5 list of u64 lanes."""
    a = lanes
    for rc in _RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        a = [[b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64)
              for y in range(5)] for x in range(5)]
        # iota
        a[0][0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (pre-SHA3 padding, as used by Ethereum / the keccak
    crate): rate 1088 bits, pad10*1 with domain byte 0x01."""
    rate = 136
    buf = bytearray(data)
    buf.append(0x01)
    while len(buf) % rate:
        buf.append(0x00)
    buf[-1] |= 0x80
    lanes = [[0] * 5 for _ in range(5)]
    for off in range(0, len(buf), rate):
        block = buf[off:off + rate]
        for i in range(rate // 8):
            x, y = i % 5, i // 5
            lanes[x][y] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        lanes = keccak_f1600(lanes)
    out = b"".join(
        lanes[i % 5][i // 5].to_bytes(8, "little") for i in range(4))
    return out[:32]


class KeccakTranscript(Blake2bTranscript):
    """Chained-digest transcript with Keccak-256 as the compression
    function; framing (labels, n_rounds prefix, challenge extraction) is
    inherited unchanged from the Blake2b transcript."""

    @staticmethod
    def _hash(data: bytes) -> bytes:
        return keccak256(data)
