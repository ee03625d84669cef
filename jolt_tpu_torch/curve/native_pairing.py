"""ctypes bindings for the native BN254 pairing (`csrc/pairing.cpp`).

Copied from the JAX package's `curve/native_pairing.py`, logic unchanged
except `load()`:

  * it builds `csrc/pairing.cpp` with g++ at first use into the gitignored
    `_build/` (to a temporary name, then `os.replace`, so processes that
    build at once do not read a half-written file), under a name that
    carries a digest of the source, the flags and the host CPU's flags:
    an edited source, or a copy of `_build/` on another host, builds anew
    rather than loading a library made for other instructions;
  * a failed build or load raises; it never selects the Python tier;
  * the Python tier is taken only when the caller asks for it by setting
    JOLT_TPU_NO_NATIVE_PAIRING (read at every call, so a test can switch
    tiers in one process): then `load()` returns None and every function
    below returns None, and its caller runs the Python tier, as in the
    JAX package.

The original notes follow.  The C++ library mirrors `pairing.py` /
`fq_tower.py` formula-for-formula, so GT elements are byte-identical to
the Python oracle; `pairing.py` routes Miller loops / final
exponentiations / GT pows here (`tests/test_torch_dory.py` pins the two
tiers equal on Dory's opening)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

from ..field.params import FQ_MODULUS as Q
from ..field.params import FR_MODULUS as R
from .fq_tower import Fq2, Fq6, Fq12

_PKG_DIR = os.path.join(os.path.dirname(__file__), "..")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SRC = os.path.join(_PKG_DIR, "csrc", "pairing.cpp")
# -march=native: BMI2/ADX carry chains ~1.3x the CIOS Montgomery cores;
# the second set is for toolchains without it
_FLAGS = (["-O3", "-march=native", "-shared", "-fPIC", "-pthread"],
          ["-O3", "-shared", "-fPIC", "-pthread"])
_FINAL_EXP = (Q ** 12 - 1) // R
_FINAL_EXP_LE = _FINAL_EXP.to_bytes((_FINAL_EXP.bit_length() + 7) // 8,
                                    "little")

_lib = None
_lock = threading.Lock()


def python_tier() -> bool:
    """True when the caller asked for the Python tier
    (JOLT_TPU_NO_NATIVE_PAIRING set)."""
    return bool(os.environ.get("JOLT_TPU_NO_NATIVE_PAIRING"))


def available() -> bool:
    return load() is not None


def _host_cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode() + platform.processor().encode()


def library_path() -> str:
    """Where the library for this source, these flags and this host's CPU
    lives under `_build/`."""
    with open(SRC, "rb") as f:
        h = hashlib.blake2b(f.read(), digest_size=8)
    h.update(repr(_FLAGS).encode())
    h.update(_host_cpu_flags())
    return os.path.join(BUILD_DIR, f"libjolt_pairing-{h.hexdigest()}.so")


def build(force: bool = False) -> str:
    """Build the library if it is not built (or, with `force`, anew);
    returns its path.  Raises when g++ fails with both flag sets."""
    so = library_path()
    if os.path.exists(so) and not force:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for i, flags in enumerate(_FLAGS):
            res = subprocess.run(["g++", *flags, "-o", tmp, SRC],
                                 capture_output=True, text=True)
            if res.returncode == 0:
                break
            if i == len(_FLAGS) - 1:
                raise RuntimeError(f"building {SRC} failed:\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load():
    """The library, built at first use; None only when the caller asked for
    the Python tier.  A failed build or load raises."""
    global _lib
    if python_tier():
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.jolt_miller_product.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p]
        lib.jolt_fq12_pow.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p]
        lib.jolt_g1_msm.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p]
        lib.jolt_g1_fold_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.jolt_g1_segment_sums.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p]
        lib.jolt_g2_mul_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p]
        lib.jolt_g2_fold_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.jolt_fr_fold.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p]
        lib.jolt_fr_dot.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p]
        lib.jolt_fr_rlc_rows_nc.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_uint64]
        lib.jolt_g1_fold_glv.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_char_p]
        _lib = lib
    return _lib


# ---- encoding (little-endian 32B canonical Fq components) -----------------

def _fq12_to_bytes(f: Fq12) -> bytes:
    out = b""
    for f6 in (f.c0, f.c1):
        for f2 in (f6.c0, f6.c1, f6.c2):
            out += f2.a.to_bytes(32, "little") + f2.b.to_bytes(32, "little")
    return out


def _fq12_from_bytes(buf: bytes) -> Fq12:
    vals = [int.from_bytes(buf[i * 32:(i + 1) * 32], "little")
            for i in range(12)]
    f2s = [Fq2(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
    return Fq12(Fq6(f2s[0], f2s[1], f2s[2]), Fq6(f2s[3], f2s[4], f2s[5]))


def miller_product(pairs: List[Tuple[Optional[tuple], object]]) -> Optional[Fq12]:
    """prod of Miller loops over (G1 affine ints, G2 affine Fq2) pairs;
    None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(pairs)
    g1 = bytearray(64 * n)
    g2 = bytearray(128 * n)
    inf = bytearray(n)
    for i, (p, q) in enumerate(pairs):
        if p is None or q is None:
            inf[i] = 1
            continue
        g1[64 * i:64 * i + 32] = p[0].to_bytes(32, "little")
        g1[64 * i + 32:64 * i + 64] = p[1].to_bytes(32, "little")
        xq, yq = q
        o = 128 * i
        g2[o:o + 32] = xq.a.to_bytes(32, "little")
        g2[o + 32:o + 64] = xq.b.to_bytes(32, "little")
        g2[o + 64:o + 96] = yq.a.to_bytes(32, "little")
        g2[o + 96:o + 128] = yq.b.to_bytes(32, "little")
    out = ctypes.create_string_buffer(384)
    lib.jolt_miller_product(bytes(g1), bytes(g2), bytes(inf), n, out)
    return _fq12_from_bytes(out.raw)


def _g2_enc(p) -> Tuple[bytes, int]:
    if p is None:
        return b"\x00" * 128, 1
    return (p[0].a.to_bytes(32, "little") + p[0].b.to_bytes(32, "little")
            + p[1].a.to_bytes(32, "little") + p[1].b.to_bytes(32, "little")), 0


def _g2_dec(buf: bytes, inf: int):
    if inf:
        return None
    v = [int.from_bytes(buf[i * 32:(i + 1) * 32], "little") for i in range(4)]
    return (Fq2(v[0], v[1]), Fq2(v[2], v[3]))


def fq12_pow(base: Fq12, e: int) -> Optional[Fq12]:
    lib = load()
    if lib is None:
        return None
    if e == 0:
        return Fq12.one()
    eb = int(e).to_bytes((e.bit_length() + 7) // 8, "little")
    out = ctypes.create_string_buffer(384)
    lib.jolt_fq12_pow(_fq12_to_bytes(base), eb, len(eb), out)
    return _fq12_from_bytes(out.raw)


def final_exp(f: Fq12) -> Optional[Fq12]:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(384)
    lib.jolt_fq12_pow(_fq12_to_bytes(f), _FINAL_EXP_LE, len(_FINAL_EXP_LE),
                      out)
    return _fq12_from_bytes(out.raw)


# ---- G1 helpers -----------------------------------------------------------

def _g1_enc_many(points):
    n = len(points)
    buf = bytearray(64 * n)
    inf = bytearray(n)
    for i, p in enumerate(points):
        if p is None:
            inf[i] = 1
        else:
            buf[64 * i:64 * i + 32] = p[0].to_bytes(32, "little")
            buf[64 * i + 32:64 * i + 64] = p[1].to_bytes(32, "little")
    return bytes(buf), bytes(inf)


def _g1_dec(buf, inf):
    if inf:
        return None
    return (int.from_bytes(buf[:32], "little"),
            int.from_bytes(buf[32:64], "little"))


def g1_msm(points, scalars):
    """MSM over host affine points; None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(points)
    if n == 0:
        return (None,)
    buf, inf = _g1_enc_many(points)
    sc = b"".join((s % R).to_bytes(32, "little") for s in scalars)
    out = ctypes.create_string_buffer(64)
    oinf = ctypes.create_string_buffer(1)
    lib.jolt_g1_msm(buf, inf, sc, n, out, oinf)
    return (_g1_dec(out.raw, oinf.raw[0]),)


def g1_enc_bases(points) -> bytes:
    """64B-affine encoding of a generator list (no infinities); cache the
    result across g1_segment_sums calls."""
    buf, inf = _g1_enc_many(points)
    assert not any(inf), "generator bases must be finite"
    return buf


def g1_segment_sums(base_buf: bytes, col, seg_off):
    """out[s] = sum_{i in segment s} base[col[i]] over G1.

    base_buf from `g1_enc_bases`; col uint32 numpy array of indices;
    seg_off uint64 numpy array of ns+1 offsets.  Returns a list of affine
    points (None = infinity), or None when the library is unavailable."""
    import numpy as np
    lib = load()
    if lib is None:
        return None
    ns = len(seg_off) - 1
    if ns <= 0:
        return []
    col = np.ascontiguousarray(col, np.uint32)
    seg_off = np.ascontiguousarray(seg_off, np.uint64)
    out = ctypes.create_string_buffer(64 * ns)
    oinf = ctypes.create_string_buffer(ns)
    lib.jolt_g1_segment_sums(base_buf, col.tobytes(), seg_off.tobytes(),
                             ns, out, oinf)
    return [_g1_dec(out.raw[64 * i:64 * (i + 1)], oinf.raw[i])
            for i in range(ns)]


# GLV endomorphism constants (BN254: phi(x,y) = (beta*x, y) acts as
# multiplication by lambda; lattice basis gives |k1|,|k2| < 2^127)
_GLV_LAM = 4407920970296243842393367215006156084916469457145843978461
_GLV_A1, _GLV_B1 = 9931322734385697763, -147946756881789319000765030803803410728
_GLV_A2, _GLV_B2 = 147946756881789319010696353538189108491, 9931322734385697763


def _glv_decompose(k: int):
    """k = k1 + k2*lambda (mod r) with short k1, k2 (signed)."""
    k %= R
    c1 = (_GLV_B2 * k + R // 2) // R
    c2 = (-_GLV_B1 * k + R // 2) // R
    k1 = k - c1 * _GLV_A1 - c2 * _GLV_A2
    k2 = -c1 * _GLV_B1 - c2 * _GLV_B2
    return k1, k2


# ---- Fr (scalar-field) vector kernels -------------------------------------
# The Dory opening's phase-B folds / inner products and combined-row build
# (canonical little-endian 32-byte lanes in C; int lists at this boundary).

def _fr_bytes(vals) -> bytes:
    return b"".join(int(v % R).to_bytes(32, "little") for v in vals)


def g1_msm_enc(base_buf: bytes, scalars, offset: int = 0):
    """MSM over PRE-ENCODED affine bases (a `g1_enc_bases` buffer,
    optionally starting at point index `offset`): skips the per-call
    point re-encoding that dominated dense Dory commits.  Zero scalars
    are skipped natively.  Returns (point|None,) or None when the
    library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(scalars)
    sc = b"".join(int(s % R).to_bytes(32, "little") for s in scalars)
    inf = b"\x00" * n
    out = ctypes.create_string_buffer(64)
    oinf = ctypes.create_string_buffer(1)
    view = base_buf[64 * offset:64 * (offset + n)]
    lib.jolt_g1_msm(view, inf, sc, n, out, oinf)
    return (_g1_dec(out.raw, oinf.raw[0]),)


# ---- buffer-level vector API ----------------------------------------------
# The Dory opening's reduce ladders call the native kernels every round.
# Keeping the G1/G2/Fr vectors as raw encoded buffers BETWEEN rounds
# removes the per-round Python big-int encode/decode, which measured more
# expensive than the native ladders themselves at 2^15+ lanes (per-lane
# int.to_bytes/from_bytes ~150us vs ~25us of native GLV ladder).
# Encodings match the C ABI exactly: G1 64B affine + 1B inf flag lanes,
# G2 128B + 1B, Fr canonical 32B LE.  All return None when the native
# library is unavailable (callers fall back to the point-list tier).

def g1_dec_many(buf, inf):
    return [_g1_dec(buf[64 * i:64 * (i + 1)], inf[i])
            for i in range(len(inf))]


def g2_dec_many(buf, inf):
    return [_g2_dec(buf[128 * i:128 * (i + 1)], inf[i])
            for i in range(len(inf))]


def g2_enc_many(points) -> Tuple[bytes, bytes]:
    n = len(points)
    buf = bytearray(128 * n)
    inf = bytearray(n)
    for i, p in enumerate(points):
        pb, pi = _g2_enc(p)
        buf[128 * i:128 * (i + 1)] = pb
        inf[i] = pi
    return bytes(buf), bytes(inf)


def g1_fold_buf(a, ai, b, bi, n: int, s: int):
    """buffer-level [a_i + s*b_i] over G1, one shared scalar (GLV ladder);
    returns (out_buf, out_inf) or None."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(64 * n)
    oinf = ctypes.create_string_buffer(n)
    k1, k2 = _glv_decompose(s % R)
    lib.jolt_g1_fold_glv(a, ai, b, bi,
                         abs(k1).to_bytes(16, "little"), int(k1 < 0),
                         abs(k2).to_bytes(16, "little"), int(k2 < 0),
                         n, out, oinf)
    return out.raw, oinf.raw


def g2_fold_buf(a, ai, b, bi, n: int, s: int):
    """buffer-level [a_i + s*b_i] over G2, one shared scalar."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(128 * n)
    oinf = ctypes.create_string_buffer(n)
    lib.jolt_g2_fold_batch(a, ai, b, bi, (s % R).to_bytes(32, "little"),
                           n, out, oinf)
    return out.raw, oinf.raw


def g2_mul_buf(q, qi, scalars):
    """buffer-level [s_i * Q_i] over G2 (lockstep batched lanes)."""
    lib = load()
    if lib is None:
        return None
    n = len(scalars)
    sc = b"".join((s % R).to_bytes(32, "little") for s in scalars)
    out = ctypes.create_string_buffer(128 * n)
    oinf = ctypes.create_string_buffer(n)
    lib.jolt_g2_mul_batch(q, sc, qi, n, out, oinf)
    return out.raw, oinf.raw


def g1_msm_buf(pts, inf, scalars):
    """MSM over an encoded G1 buffer; zero scalars / infinity lanes skip
    natively.  scalars: int list OR a raw canonical-32B-LE buffer.
    Returns (point|None,) or None when unavailable."""
    lib = load()
    if lib is None:
        return None
    if isinstance(scalars, (bytes, bytearray)):
        n = len(scalars) // 32
        sc = bytes(scalars)
    else:
        n = len(scalars)
        sc = b"".join(int(s % R).to_bytes(32, "little") for s in scalars)
    if n == 0:
        return (None,)
    out = ctypes.create_string_buffer(64)
    oinf = ctypes.create_string_buffer(1)
    lib.jolt_g1_msm(pts, inf, sc, n, out, oinf)
    return (_g1_dec(out.raw, oinf.raw[0]),)


def pairing_product_buf(g1b, g1i, g2b, g2i, n: int):
    """prod e(P_i, Q_i) over encoded buffers with one shared final exp
    (skips lanes where either side is infinity); Fq12 or None."""
    lib = load()
    if lib is None:
        return None
    inf = bytes(x | y for x, y in zip(g1i, g2i))
    out = ctypes.create_string_buffer(384)
    lib.jolt_miller_product(g1b, g2b, inf, n, out)
    return final_exp(_fq12_from_bytes(out.raw))


def fr_fold_buf(a, b, alpha: int, n: int):
    """buffer-level [alpha*a_i + b_i] mod r (canonical 32B lanes)."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32 * n)
    lib.jolt_fr_fold(a, b, int(alpha % R).to_bytes(32, "little"), n, out)
    return out.raw


def fr_dot_buf(a, b, n: int):
    """sum_i a_i * b_i mod r over canonical 32B-lane buffers."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    lib.jolt_fr_dot(a, b, n, out)
    return int.from_bytes(out.raw, "little")


def fr_enc(vals) -> bytes:
    return _fr_bytes(vals)


# ---- list forms ------------------------------------------------------------
# The JAX package's point-list and int-list API over the buffer forms
# above: the same native calls, encoded and decoded at this boundary.
# Each returns None when the library is unavailable.

def _fr_ints(buf: bytes):
    return [int.from_bytes(buf[32 * i:32 * (i + 1)], "little")
            for i in range(len(buf) // 32)]


def g1_fold_batch(a, b, scalars):
    """[a_i + s_i * b_i] over G1 lanes.  Shared-scalar calls (every Dory
    fold site) take the GLV fast path (`g1_fold_buf`); per-lane scalars
    a double-and-add ladder a lane."""
    lib = load()
    if lib is None:
        return None
    n = len(a)
    ab, ai = _g1_enc_many(a)
    bb, bi = _g1_enc_many(b)
    s0 = scalars[0] % R
    if all(s % R == s0 for s in scalars):
        out, oinf = g1_fold_buf(ab, ai, bb, bi, n, s0)
    else:
        sc = b"".join((s % R).to_bytes(32, "little") for s in scalars)
        buf = ctypes.create_string_buffer(64 * n)
        inf = ctypes.create_string_buffer(n)
        lib.jolt_g1_fold_batch(ab, ai, bb, bi, sc, n, buf, inf)
        out, oinf = buf.raw, inf.raw
    return g1_dec_many(out, oinf)


def g2_mul_batch(points: List, scalars: List[int]) -> Optional[List]:
    """[s_i * Q_i] (threaded native lanes)."""
    res = g2_mul_buf(*g2_enc_many(points), scalars)
    return None if res is None else g2_dec_many(*res)


def g2_fold_batch(a: List, b: List, s: int) -> Optional[List]:
    """[a_i + s * b_i] with one shared scalar."""
    res = g2_fold_buf(*g2_enc_many(a), *g2_enc_many(b), len(a), s)
    return None if res is None else g2_dec_many(*res)


def fr_fold(a, b, alpha: int):
    """[alpha * a_i + b_i] mod r."""
    out = fr_fold_buf(_fr_bytes(a), _fr_bytes(b), alpha, len(a))
    return None if out is None else _fr_ints(out)


def fr_dot(a, b):
    """sum_i a_i * b_i mod r."""
    return fr_dot_buf(_fr_bytes(a), _fr_bytes(b), len(a))


def fr_combined_row(parts, L, ncols: int, sigma: int):
    """`fr_combined_row_buf` as the length-ncols int list."""
    out = fr_combined_row_buf(parts, L, ncols, sigma)
    return None if out is None else _fr_ints(out)


def fr_combined_row_buf(parts, L, ncols: int, sigma: int):
    """Combined row s of the sparse RLC matrix: for every part
    (positions int64 array, weight w, values|None),
        s[pos & (ncols-1)] += w * L[pos >> sigma] * (value or 1),
    as the raw canonical 32B-lane buffer (feeds the phase-B MSMs/folds
    without a decode round-trip); None when unavailable."""
    import numpy as np
    lib = load()
    if lib is None:
        return None
    acc = ctypes.create_string_buffer(32 * ncols)
    L_b = _fr_bytes(L)
    for positions, w, values in parts:
        pos = np.ascontiguousarray(positions, np.int64)
        rows = (pos >> sigma).astype(np.uint32)
        cols = (pos & (ncols - 1)).astype(np.uint32)
        vb = None if values is None else _fr_bytes(values)
        lib.jolt_fr_rlc_rows_nc(rows.tobytes(), cols.tobytes(), vb,
                                int(w % R).to_bytes(32, "little"),
                                len(pos), L_b, acc, ncols)
    return acc.raw
