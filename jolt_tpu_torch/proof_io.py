"""Canonical proof serialization: stable bytes, no pickle on the wire.

Copied from the JAX package's `proof_io.py`, codec logic unchanged: the
port's proofs serialize to the JAX package's bytes, and each package
decodes the other's.  `_enc_value` dispatches on the port's classes
(`JoltProof`, `DoryCommitment`, `DoryProof`, `HyperKZGProof`,
`BlindFoldProof`).  The original notes follow.

Analog of the reference's `CanonicalSerialize` proof encoding
(`jolt-verifier` consumes arkworks-compressed points and 32-byte LE field
elements).  Layout rules:

  * field scalars: 32-byte little-endian (arkworks `Fr` convention);
  * G1 points: 32-byte arkworks-compressed (x LE; top byte carries the
    infinity flag 0x40 and the y-lexicographic-sign flag 0x80);
  * G2 points: 64-byte arkworks-compressed (x = c0||c1 LE; flags in the
    top byte of c1: 0x40 infinity, 0x80 y-lexicographically-largest);
  * GT (Fq12): 12 x 32 bytes LE, tower order c0.c0.a .. c1.c2.b;
  * lists: u32 LE count, then items; dicts: count + (u16 key-len, key,
    value) with keys in insertion order (the proof's canonical order).

The JoltProof container is encoded schema-driven from its dataclass
fields, so adding a stage slot extends the format mechanically.  A version
byte leads; `deserialize_proof` rejects unknown versions.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

from .curve import bn254_host as host
from .curve.fq_tower import Fq2, Fq6, Fq12
from .field.params import FR
from .blindfold.prove import BlindFoldProof
from .pcs.dory import DoryCommitment, DoryProof
from .pcs.hyperkzg import HyperKZGProof
from .prover.prover import JoltProof

P = FR.modulus
Q = host.Q if hasattr(host, "Q") else None
VERSION = 8


class ProofDecodeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _fq_modulus() -> int:
    from .curve.bn254_host import Q as fq
    return fq


def enc_scalar(v: int) -> bytes:
    return (v % P).to_bytes(32, "little")


def dec_scalar(b: memoryview, off: int):
    return int.from_bytes(b[off:off + 32], "little"), off + 32


def sqrt_fq(a: int) -> int:
    """Square root in Fq (q = 3 mod 4)."""
    q = _fq_modulus()
    r = pow(a, (q + 1) // 4, q)
    if r * r % q != a % q:
        raise ProofDecodeError("non-residue x^3+3: point not on curve")
    return r


def enc_g1(pt) -> bytes:
    """arkworks-compressed G1 (32 bytes)."""
    if pt is None:
        out = bytearray(32)
        out[31] = 0x40
        return bytes(out)
    x, y = pt
    q = _fq_modulus()
    out = bytearray((x % q).to_bytes(32, "little"))
    if y % q > (q - 1) // 2:
        out[31] |= 0x80
    return bytes(out)


def dec_g1(b: memoryview, off: int):
    raw = bytearray(b[off:off + 32])
    off += 32
    flags = raw[31] & 0xC0
    raw[31] &= 0x3F
    if flags & 0x40:
        return None, off
    q = _fq_modulus()
    x = int.from_bytes(bytes(raw), "little")
    if x >= q:
        raise ProofDecodeError("G1 x out of range")
    y = sqrt_fq((x * x % q * x + 3) % q)
    if (y > (q - 1) // 2) != bool(flags & 0x80):
        y = q - y
    pt = (x, y)
    if not host.g1_is_on_curve(pt):
        raise ProofDecodeError("decoded G1 point off curve")
    return pt, off


def _fq2_sqrt(a: Fq2) -> Fq2:
    """Square root in Fq2 = Fq[u]/(u^2+1) for q = 3 mod 4
    (Adj--Rodriguez-Henriquez; arkworks `sqrt` for quadratic extensions)."""
    q = _fq_modulus()
    if a.is_zero():
        return Fq2(0, 0)
    a1 = a.pow((q - 3) // 4)
    x0 = a1 * a
    alpha = a1 * x0
    if alpha == Fq2(q - 1, 0):          # alpha == -1: x = u * x0 (u^2 = -1)
        x = Fq2(0, 1) * x0
    else:
        x = (Fq2(1, 0) + alpha).pow((q - 1) // 2) * x0
    if x.sqr() != a:
        raise ProofDecodeError("Fq2 non-residue: G2 point not on curve")
    return x


def _fq2_is_largest(y: Fq2) -> bool:
    """arkworks QuadExtField ordering: compare the u-coefficient (c1)
    first, then c0; the compression flag marks the larger of (y, -y)."""
    ny = -y
    return (y.b, y.a) > (ny.b, ny.a)


# G2 twist coefficient b' = 3/(9+u)
def _g2_b() -> Fq2:
    from .curve.fq_tower import XI
    return Fq2(3, 0) * XI.inv()


def enc_g2(pt) -> bytes:
    """arkworks-compressed G2 (64 bytes): x = c0||c1 (32 LE bytes each),
    flags in the top byte of c1 (0x40 infinity, 0x80 y-is-largest)."""
    if pt is None:
        out = bytearray(64)
        out[63] = 0x40
        return bytes(out)
    (x, y) = pt
    q = _fq_modulus()
    out = bytearray((x.a % q).to_bytes(32, "little")
                    + (x.b % q).to_bytes(32, "little"))
    if _fq2_is_largest(y):
        out[63] |= 0x80
    return bytes(out)


def dec_g2(b: memoryview, off: int):
    c0 = int.from_bytes(b[off:off + 32], "little")
    c1b = bytearray(b[off + 32:off + 64])
    off += 64
    flags = c1b[31] & 0xC0
    c1b[31] &= 0x3F
    c1 = int.from_bytes(bytes(c1b), "little")
    if flags & 0x40:
        if c0 or c1:
            raise ProofDecodeError("nonzero x with G2 infinity flag")
        return None, off
    x = Fq2(c0, c1)
    y = _fq2_sqrt(x.sqr() * x + _g2_b())
    if _fq2_is_largest(y) != bool(flags & 0x80):
        y = -y
    return (x, y), off


def _fq12_flat(e: Fq12) -> List[int]:
    out = []
    for c6 in (e.c0, e.c1):
        for c2 in (c6.c0, c6.c1, c6.c2):
            out += [c2.a, c2.b]
    return out


def enc_gt(e: Fq12) -> bytes:
    q = _fq_modulus()
    return b"".join((v % q).to_bytes(32, "little") for v in _fq12_flat(e))


def dec_gt(b: memoryview, off: int):
    vals = []
    for _ in range(12):
        vals.append(int.from_bytes(b[off:off + 32], "little"))
        off += 32
    c2s = [Fq2(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
    return Fq12(Fq6(c2s[0], c2s[1], c2s[2]), Fq6(c2s[3], c2s[4], c2s[5])), off


def enc_u32(n: int) -> bytes:
    return struct.pack("<I", n)


def enc_u64(n: int) -> bytes:
    return struct.pack("<Q", n)


# ---------------------------------------------------------------------------
# schema-driven value codec
# ---------------------------------------------------------------------------

_TAG_SCALAR, _TAG_LIST, _TAG_DICT, _TAG_G1, _TAG_GT, _TAG_G2 = range(6)
_TAG_INT64, _TAG_DORY_COMM, _TAG_DORY_PROOF, _TAG_HKZG_PROOF = range(6, 10)
_TAG_NONE, _TAG_STR, _TAG_BYTES = 10, 11, 12
_TAG_BLINDFOLD = 13


def _enc_value(v, out: bytearray) -> None:
    if v is None:
        out.append(_TAG_NONE)
    elif isinstance(v, bool):
        out.append(_TAG_INT64)
        out += enc_u64(int(v))
    elif isinstance(v, int):
        if 0 <= v < (1 << 64):
            out.append(_TAG_INT64)
            out += enc_u64(v)
        else:
            out.append(_TAG_SCALAR)
            out += enc_scalar(v)
    elif isinstance(v, str):
        out.append(_TAG_STR)
        raw = v.encode()
        out += enc_u32(len(raw)) + raw
    elif isinstance(v, (bytes, bytearray)):
        out.append(_TAG_BYTES)
        out += enc_u32(len(v)) + bytes(v)
    elif _is_pointish(v):
        _enc_g1_or_g2(v, out)
    elif isinstance(v, (list, tuple)):
        out.append(_TAG_LIST)
        out += enc_u32(len(v))
        for x in v:
            _enc_value(x, out)
    elif isinstance(v, dict):
        out.append(_TAG_DICT)
        out += enc_u32(len(v))
        for k, x in v.items():
            raw = str(k).encode()
            out += struct.pack("<H", len(raw)) + raw
            _enc_value(x, out)
    elif isinstance(v, Fq12):
        out.append(_TAG_GT)
        out += enc_gt(v)
    elif isinstance(v, DoryCommitment):
        out.append(_TAG_DORY_COMM)
        out += enc_gt(v.c)
    elif isinstance(v, DoryProof):
        out.append(_TAG_DORY_PROOF)
        _enc_fields(v, out)
    elif isinstance(v, HyperKZGProof):
        out.append(_TAG_HKZG_PROOF)
        _enc_fields(v, out)
    elif isinstance(v, BlindFoldProof):
        out.append(_TAG_BLINDFOLD)
        _enc_fields(v, out)
    else:
        raise TypeError(f"unencodable proof field type {type(v)}")


def _enc_g1_or_g2(v, out: bytearray) -> None:
    # G1/G2 points appear only inside the PCS dataclasses whose field
    # names pin the type; here we distinguish by coordinate type
    if v is None or isinstance(v[0], int):
        out.append(_TAG_G1)
        out += enc_g1(v)
    else:
        out.append(_TAG_G2)
        out += enc_g2(v)


def _enc_fields(obj, out: bytearray) -> None:
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if _is_pointish(v):
            _enc_g1_or_g2(v, out)
        elif (isinstance(v, list) and v and _is_pointish(v[0])):
            out.append(_TAG_LIST)
            out += enc_u32(len(v))
            for x in v:
                _enc_g1_or_g2(x, out)
        else:
            _enc_value(v, out)


def _is_pointish(v) -> bool:
    if v is None:
        return False  # ambiguous; PCS fields with None points encode as G1
    if not (isinstance(v, tuple) and len(v) == 2):
        return False
    if isinstance(v[0], Fq2):
        return True
    return (isinstance(v[0], int) and isinstance(v[1], int)
            and host.g1_is_on_curve(v))


def _dec_value(b: memoryview, off: int):
    tag = b[off]
    off += 1
    if tag == _TAG_NONE:
        return None, off
    if tag == _TAG_INT64:
        return struct.unpack_from("<Q", b, off)[0], off + 8
    if tag == _TAG_SCALAR:
        return dec_scalar(b, off)
    if tag == _TAG_STR:
        n = struct.unpack_from("<I", b, off)[0]
        off += 4
        return bytes(b[off:off + n]).decode(), off + n
    if tag == _TAG_BYTES:
        n = struct.unpack_from("<I", b, off)[0]
        off += 4
        return bytes(b[off:off + n]), off + n
    if tag == _TAG_LIST:
        n = struct.unpack_from("<I", b, off)[0]
        off += 4
        out = []
        for _ in range(n):
            v, off = _dec_value(b, off)
            out.append(v)
        return out, off
    if tag == _TAG_DICT:
        n = struct.unpack_from("<I", b, off)[0]
        off += 4
        out = {}
        for _ in range(n):
            klen = struct.unpack_from("<H", b, off)[0]
            off += 2
            k = bytes(b[off:off + klen]).decode()
            off += klen
            v, off = _dec_value(b, off)
            out[k] = v
        return out, off
    if tag == _TAG_G1:
        return dec_g1(b, off)
    if tag == _TAG_G2:
        return dec_g2(b, off)
    if tag == _TAG_GT:
        return dec_gt(b, off)
    if tag == _TAG_DORY_COMM:
        c, off = dec_gt(b, off)
        return DoryCommitment(c=c), off
    if tag == _TAG_DORY_PROOF:
        vals = []
        for f in dataclasses.fields(DoryProof):
            v, off = _dec_value(b, off)
            vals.append(v)
        return DoryProof(*vals), off
    if tag == _TAG_HKZG_PROOF:
        vals = []
        for f in dataclasses.fields(HyperKZGProof):
            v, off = _dec_value(b, off)
            vals.append(v)
        return HyperKZGProof(*vals), off
    if tag == _TAG_BLINDFOLD:
        vals = []
        for f in dataclasses.fields(BlindFoldProof):
            v, off = _dec_value(b, off)
            vals.append(v)
        return BlindFoldProof(*vals), off
    raise ProofDecodeError(f"unknown tag {tag}")


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def serialize_proof(proof: JoltProof, statement: dict = None) -> bytes:
    out = bytearray([VERSION])
    _enc_value(statement or {}, out)
    _enc_fields(proof, out)
    return bytes(out)


def deserialize_proof(data: bytes):
    """-> (JoltProof, statement dict)."""
    b = memoryview(data)
    if b[0] != VERSION:
        raise ProofDecodeError(f"unsupported proof version {b[0]}")
    off = 1
    statement, off = _dec_value(b, off)
    vals = []
    for f in dataclasses.fields(JoltProof):
        v, off = _dec_value(b, off)
        vals.append(v)
    if off != len(data):
        raise ProofDecodeError(f"{len(data) - off} trailing bytes")
    return JoltProof(*vals), statement
