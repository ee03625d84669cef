"""Bit-exact Blake2b-256 Fiat-Shamir transcript.

Byte-for-byte reimplementation of the reference's wire-compatible transcript
(`reference crates/jolt-prover-legacy/src/transcripts/blake2b.rs` and
the `Transcript` trait defaults in `transcripts/transcript.rs`):

  * 32-byte running ``state``; every absorb/squeeze computes
    ``Blake2b256(state || 28 zero bytes || n_rounds_be_u32 || payload)``
    and replaces the state with the digest, incrementing ``n_rounds``.
  * ``new(label)``: state = Blake2b256(label right-zero-padded to 32 bytes).
  * Scalars absorb as big-endian 32-byte words (EVM uint256 layout);
    challenges are 128-bit (16 LE bytes of a 32-byte squeeze, reversed).

The transcript is host-side by design: it is inherently sequential, tiny, and
forms the seam between device kernels (transcript-free) and the protocol
driver — exactly the reference's kernel-seam invariant
(`specs/clean-slate-prover.md:195-199`).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Optional

from ..field.params import FR, FieldParams


def _blake2b256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


class Blake2bTranscript:
    """The wire-compatible Fiat-Shamir transcript (`LegacyBlake2bTranscript`)."""

    @staticmethod
    def _hash(data: bytes) -> bytes:
        """The 32-byte compression function; subclasses (Keccak) swap it."""
        return _blake2b256(data)

    def __init__(self, label: bytes, fp: FieldParams = FR,
                 record_history: bool = False, record_events: bool = False):
        assert len(label) < 33
        self.fp = fp
        self.state = self._hash(label + b"\x00" * (32 - len(label)))
        self.n_rounds = 0
        self.history: Optional[List[bytes]] = [self.state] if record_history else None
        # FS-obligation audit tape: (op, payload-digest) per absorb/squeeze
        # (`jolt-verifier/src/fs_audit.rs`: every absorb/challenge expression
        # has a stable identity; prover and verifier tapes must be EQUAL)
        self.events: Optional[List[tuple]] = [] if record_events else None

    # ---- internals ----------------------------------------------------

    def _prefix(self) -> bytes:
        # state || 28 zero bytes || n_rounds as big-endian u32
        return self.state + b"\x00" * 28 + self.n_rounds.to_bytes(4, "big")

    def _update(self, new_state: bytes) -> None:
        self.state = new_state
        self.n_rounds += 1
        if self.history is not None:
            self.history.append(new_state)

    def _absorb(self, payload: bytes) -> None:
        if self.events is not None:
            import hashlib as _h
            self.events.append(
                ("absorb", _h.blake2b(payload, digest_size=8).hexdigest()))
        self._update(self._hash(self._prefix() + payload))

    def _challenge_bytes32(self) -> bytes:
        if self.events is not None:
            self.events.append(("challenge", ""))
        rand = self._hash(self._prefix())
        self._update(rand)
        return rand

    def _challenge_bytes(self, n: int) -> bytes:
        out = b""
        while n > 32:
            out += self._challenge_bytes32()
            n -= 32
        out += self._challenge_bytes32()[:n]
        return out

    # ---- raw append methods (blake2b.rs:109-145) -----------------------

    def raw_append_label(self, label: bytes) -> None:
        assert len(label) < 33
        self._absorb(label + b"\x00" * (32 - len(label)))

    def raw_append_bytes(self, data: bytes) -> None:
        self._absorb(data)

    def raw_append_u64(self, x: int) -> None:
        self._absorb(b"\x00" * 24 + int(x).to_bytes(8, "big"))

    def raw_append_scalar(self, scalar: int) -> None:
        # arkworks serialize_uncompressed = 32 LE bytes, then reversed -> BE
        self._absorb(int(scalar % self.fp.modulus).to_bytes(32, "big"))

    def raw_append_label_with_len(self, label: bytes, length: int) -> None:
        # transcript.rs:23-37 -- label (<=24B, right-padded) || be u64 length
        assert len(label) <= 24
        packed = label + b"\x00" * (24 - len(label)) + int(length).to_bytes(8, "big")
        self.raw_append_bytes(packed)

    # ---- labeled public API (transcript.rs:49-160) ---------------------

    def append_label(self, label: bytes) -> None:
        self.raw_append_label(label)

    def append_bytes(self, label: bytes, data: bytes) -> None:
        self.raw_append_label_with_len(label, len(data))
        self.raw_append_bytes(data)

    def append_u64(self, label: bytes, x: int) -> None:
        self.raw_append_label(label)
        self.raw_append_u64(x)

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.raw_append_label(label)
        self.raw_append_scalar(scalar)

    def append_scalars(self, label: bytes, scalars: Iterable[int]) -> None:
        scalars = list(scalars)
        self.raw_append_label_with_len(label, len(scalars))
        for s in scalars:
            self.raw_append_scalar(s)

    def append_serializable_bytes(self, label: bytes, buf_le: bytes) -> None:
        """`append_serializable`: uncompressed-LE buffer, reversed, absorbed."""
        self.raw_append_label_with_len(label, len(buf_le))
        self.raw_append_bytes(bytes(reversed(buf_le)))

    def append_commitment_bytes(self, label: bytes, compressed: bytes) -> None:
        """`append_commitment`: arkworks compressed point bytes."""
        self.raw_append_label(label)
        self.raw_append_bytes(compressed)

    # ---- challenges (blake2b.rs:149-207) --------------------------------

    def challenge_u128(self) -> int:
        """LE-read of a 16-byte squeeze (blake2b.rs:149-154: reverse + from_be)."""
        return int.from_bytes(self._challenge_bytes(16), "little")

    def challenge_scalar(self) -> int:
        """128-bit challenge as a field element (challenge_scalar_128_bits):
        the 16-byte squeeze is reversed then read via from_le_bytes_mod_order
        (ark.rs:198-200), i.e. a BE-read of the original bytes."""
        return int.from_bytes(self._challenge_bytes(16), "big") % self.fp.modulus

    def challenge_scalar_optimized(self) -> int:
        """`challenge_scalar_optimized`: MontU128Challenge built from the
        LE-read u128 with the top 3 bits masked off -- only the low 125 bits
        are used (challenge/mont_ark_u128.rs:96-109).  A *different* value
        than challenge_scalar."""
        return self.challenge_u128() & ((1 << 125) - 1)

    def challenge_vector(self, n: int) -> List[int]:
        return [self.challenge_scalar() for _ in range(n)]

    def challenge_scalar_powers(self, n: int) -> List[int]:
        q = self.challenge_scalar()
        out = [1] * n
        for i in range(1, n):
            out[i] = (out[i - 1] * q) % self.fp.modulus
        return out
