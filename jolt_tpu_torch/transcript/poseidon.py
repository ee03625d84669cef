"""Circom-compatible Poseidon over BN254 Fr + transcript variant.

Copied from the JAX package's `transcript/poseidon.py` (host code,
logic unchanged).

Analog of the reference's `PoseidonTranscript`
(`crates/jolt-transcript/src/poseidon.rs`: light-poseidon's
`Poseidon::new_circom` width-4 compression behind a duplex sponge) -- the
circuit-friendly transcript for on-chain / recursive verification.

Parameters are generated with the Grain-LFSR procedure of the Poseidon
reference implementation (`generate_parameters_grain.sage`: field tag 1,
s-box x^5 tag 0, n = 254, R_F = 8, R_P per width from circomlib's
N_ROUNDS_P table; MDS = Cauchy matrix 1/(x_i + y_j) with x_i = i,
y_j = t + j).  Round counts and s-box match circomlib exactly; the
CONSTANTS are procedure-faithful but not yet byte-checked against
circomlibjs's exported tables (no fixtures/network in this image) -- the
cross-check is a one-test job once a circomlib constants dump is
available, and the transcript protocol is constant-set-agnostic.

The transcript reuses the chained-digest framing (labels, n_rounds prefix,
challenge extraction) of the Blake2b transcript, with the compression
function replaced by a Poseidon fold over 31-byte field chunks -- byte
traffic maps injectively into Fr (248 bits < p), mirroring the reference
sponge's `ABSORB_CHUNK_BYTES = 31`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..field.params import FR
from .blake2b import Blake2bTranscript

P = FR.modulus

# circomlib N_ROUNDS_P for t = 2..17 (poseidon_constants generation)
_N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64,
               68]
_R_F = 8

_PARAMS: Dict[int, Tuple[List[int], List[List[int]]]] = {}


class _Grain:
    """The 80-bit Grain LFSR of the Poseidon reference implementation."""

    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254,
                 field_tag: int = 1, sbox_tag: int = 0):
        bits: List[int] = []

        def put(v, width):
            bits.extend((v >> (width - 1 - i)) & 1 for i in range(width))

        put(field_tag, 2)
        put(sbox_tag, 4)
        put(n, 12)
        put(t, 12)
        put(r_f, 10)
        put(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def bit(self) -> int:
        """Rejection-filtered output bit: emit the bit after each 1."""
        while True:
            if self._clock() == 1:
                return self._clock()

    def field_element(self, n: int = 254) -> int:
        while True:
            v = 0
            for _ in range(n):
                v = (v << 1) | self.bit()
            if v < P:
                return v


def _params(t: int) -> Tuple[List[int], List[List[int]]]:
    """(round constants [(R_F+R_P)*t], MDS [t][t]) for width t."""
    if t not in _PARAMS:
        r_p = _N_ROUNDS_P[t - 2]
        g = _Grain(t, _R_F, r_p)
        consts = [g.field_element() for _ in range((_R_F + r_p) * t)]
        mds = [[pow(((i) + (t + j)) % P, P - 2, P) for j in range(t)]
               for i in range(t)]
        _PARAMS[t] = (consts, mds)
    return _PARAMS[t]


def poseidon_permutation(state: Sequence[int]) -> List[int]:
    """The full Poseidon permutation on a width-t state (circomlib round
    structure: ark -> s-box (x^5, partial on slot 0) -> MDS mix)."""
    t = len(state)
    consts, mds = _params(t)
    r_p = _N_ROUNDS_P[t - 2]
    s = [x % P for x in state]
    half = _R_F // 2
    for r in range(_R_F + r_p):
        s = [(x + consts[r * t + i]) % P for i, x in enumerate(s)]
        if r < half or r >= half + r_p:
            s = [pow(x, 5, P) for x in s]
        else:
            s[0] = pow(s[0], 5, P)
        # circomlib mix: out[i] = sum_j M[j][i] * s[j]
        s = [sum(mds[j][i] * s[j] for j in range(t)) % P for i in range(t)]
    return s


def poseidon_hash(inputs: Sequence[int]) -> int:
    """circomlib `poseidon(inputs)`: permute [0, *inputs], take slot 0."""
    return poseidon_permutation([0] + [x % P for x in inputs])[0]


class PoseidonTranscript(Blake2bTranscript):
    """Chained-digest transcript with a Poseidon compression function:
    payload bytes fold into the running Fr state as 31-byte LE chunks via
    the width-4 circom compression (3 inputs/call), and the 32-byte digest
    is the LE encoding of the final state."""

    @staticmethod
    def _hash(data: bytes) -> bytes:
        chunks = [int.from_bytes(data[i:i + 31], "little")
                  for i in range(0, max(len(data), 1), 31)]
        if len(chunks) % 2:
            chunks.append(0)
        acc = len(data) % P   # length tag: domain-separates padded inputs
        for i in range(0, len(chunks), 2):
            acc = poseidon_hash([acc, chunks[i], chunks[i + 1]])
        return acc.to_bytes(32, "little")
