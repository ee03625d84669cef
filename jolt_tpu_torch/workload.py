"""The main path's workload, the card it runs on, and the least time the
card could take for each kernel's work.

The workload is `bench.py`'s: the sha2-chain guest
(`examples/gen_sha256.py:emit_inline`, ~2.3k cycles per SHA-256
compression), hashing `SHA2_INPUT` `SHA2_CHAIN` times, which lands the trace
at ~2^18 cycles.  `chip_smoke.py` and `profile_prefix.py` run it at that
size, and `chip_smoke.py` at `SHA2_CHAIN_2_20` (2^20, stage 1's streaming
tier); the tests run it at chain=1.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import math
import os
import pathlib
import re
import subprocess
from typing import Callable, Dict, Tuple

import numpy as np

from .riscv.emulator import MemoryLayout
from .tracer.native import trace_program_native
from .tracer.trace import Trace

SHA2_CHAIN = 114          # ~2^18 cycles, the bench's size
# the streaming tier's size: 1,028,514 cycles, padded to 2^20 (stage 1
# streams from `spartan_outer.STREAM_THRESHOLD`, 2^19)
SHA2_CHAIN_2_20 = 450
SHA2_CHAIN_2_20_CYCLES = 1_028_514
SHA2_INPUT = bytes(range(32))
_GEN_SHA256 = (pathlib.Path(__file__).resolve().parent.parent / "examples"
               / "gen_sha256.py")
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 3.35 TB/s;
# 32-bit integer multiply-adds on the CUDA cores: 132 SMs x 64 per clock x
# 1.98 GHz = 16.7 T/s (half of the 67 TFLOP/s float32 rate's FMA count)
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9
# one Fr Montgomery product: 136 32x32->64 multiplies = 272 multiply-adds
MADS_PER_PRODUCT = 272
# the least work that takes exact limb sums S = lo + h 2^256 (lo < 2^256
# < 6p, h < 2^32) to S mod p: h (2^256 mod p) and a one-word quotient of lo
# times p, 8 words by 1 each: 16 32x32->64 multiplies = 32 multiply-adds
MADS_PER_FOLD = 32


def sha2_chain_layout() -> MemoryLayout:
    return MemoryLayout(max_input_size=64, max_output_size=64)


def sha2_chain_source(layout: MemoryLayout, chain: int) -> str:
    """The guest's assembly; the generator imports nothing, so it is loaded
    by file path."""
    spec = importlib.util.spec_from_file_location("gen_sha256", _GEN_SHA256)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen.emit_inline(input_start=layout.input_start,
                           output_start=layout.output_start,
                           termination=layout.termination, chain=chain)


def sha2_chain_digest(chain: int) -> bytes:
    out = SHA2_INPUT
    for _ in range(chain):
        out = hashlib.sha256(out).digest()
    return out


def sha2_chain_trace(chain: int = SHA2_CHAIN) -> Trace:
    """Trace the guest with the native tracer; raises if its output is not
    the SHA-256 chain of the input."""
    layout = sha2_chain_layout()
    trace = trace_program_native(sha2_chain_source(layout, chain),
                                 layout=layout, inputs=SHA2_INPUT)
    if bytes(trace.device.outputs[:32]) != sha2_chain_digest(chain):
        raise RuntimeError(f"sha2-chain output wrong (chain={chain})")
    return trace


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def host_line() -> str:
    """The host's CPU (model name, vendor, family and model as
    /proc/cpuinfo gives them; a VM may report the name as unknown) and the
    CPUs this process may use (`nproc`): the Dory stages are host work."""
    info: Dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                       # the first processor only
                key, _, val = line.partition(":")
                info[key.strip()] = val.strip()
    except OSError:
        pass
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id')} "
            f"family {info.get('cpu family')} model {info.get('model')}), "
            f"nproc {len(os.sched_getaffinity(0))}")


def timed_stages(fn: Callable[[], object]
                 ) -> Tuple[object, Dict[str, float], str, Dict[str, dict]]:
    """Run `fn()` with the prover's stage timing on (JOLT_TPU_STAGE_TIMING);
    return its result, the seconds of each stage, the printed lines, and
    each stage's kernel launches as the lines give them:
    {label: {"k1": {form: n}, "k2": n, "k3": {form: n}, "k4": n}}."""
    buf = io.StringIO()
    os.environ["JOLT_TPU_STAGE_TIMING"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        del os.environ["JOLT_TPU_STAGE_TIMING"]
    text = buf.getvalue()
    stages, launches = {}, {}
    line = (r"\[prove\] ([\w-]+): ([0-9.]+)s.* k1=(\S+) k2=(\d+) k3=(\S+) "
            r"k4=(\d+)")

    def forms(text):
        return {f: int(n) for f, n in (kv.split(":")
                                       for kv in text.split(","))}
    for m in re.finditer(line, text):
        stages[m.group(1)] = float(m.group(2))
        launches[m.group(1)] = {"k1": forms(m.group(3)),
                                "k2": int(m.group(4)),
                                "k3": forms(m.group(5)),
                                "k4": int(m.group(6))}
    return out, stages, text, launches


def stage_device_s(prof) -> Dict[str, float]:
    """Per stage of a `torch.profiler` trace of a timed prove (one taken
    inside `timed_stages`, whose stage ends are the "[prove] <label>"
    ranges): the device seconds of the kernels and copies that start
    between the end of the stage before and the stage's own end.  Every
    stage ends in a blocking copy, so its device work does not run into
    the next."""
    from torch.autograd import DeviceType
    ends = sorted((e.time_range.start, e.name[len("[prove] "):])
                  for e in prof.events()
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith("[prove] "))
    out: Dict[str, float] = {label: 0.0 for _, label in ends}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            label = next((lb for t, lb in ends if e.time_range.start <= t),
                         "after the last stage")
            out[label] = out.get(label, 0.0) + e.time_range.elapsed_us() / 1e6
    return out


def bound_ms(n_bytes: int, products: int, mads: int = 0
             ) -> Tuple[float, str]:
    """The least time for a kernel that moves `n_bytes` and does `products`
    Montgomery products and `mads` more multiply-adds, in ms, and which of
    the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (products * MADS_PER_PRODUCT + mads) / INT32_MAD_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _numel(shape) -> int:
    """Field elements (or int64 sum columns) of an (8, *batch) shape; an
    int operand (a value in the kernel's parameters) is 0."""
    return 0 if shape == "int" or shape is None else math.prod(shape[1:])


def k1_bound_ms(form: str, key) -> Tuple[float, str]:
    """One K1 launch of `form` with the record `key` (`kernels.record`):
    each operand read once (32 B an element; the reduce form's int64 sums
    64 B), the output written once, and `MADS_PER_PRODUCT` per product --
    one an output for "mul" and "bind", none for "add", "sub" and "evals";
    "reduce" needs its folds (`MADS_PER_FOLD`) and one product only with a
    scale.  This counts what the function needs, not what the kernel does
    (the reduce form folds h and lo with two full products)."""
    if form in ("mul", "add", "sub"):
        a, b = key
        n = math.prod(np.broadcast_shapes(*[s[1:] for s in key
                                            if s != "int"]))
        return bound_ms(32 * (_numel(a) + _numel(b) + n),
                        n if form == "mul" else 0)
    if form == "bind":
        lo, _, r = key
        n = _numel(lo)
        return bound_ms(32 * (3 * n + (_numel(r) if r != "int" else 0)), n)
    if form == "evals":
        lo, degree, _ = key
        n = _numel(lo)
        return bound_ms(32 * (2 + degree) * n, 0)
    cols, scale = key
    n = _numel(cols)
    return bound_ms(64 * n + 32 * (n + _numel(scale)),
                    0 if scale is None else n, MADS_PER_FOLD * n)


def k2_bound_ms(nf: int, order: str, T: int, blocks: int) -> Tuple[float, str]:
    """One K2 call in `order` at T entries a factor: the factors (and r)
    read once, the bound factors, the blocks' (8 nf) uint64 column sums and
    the message written once; a product per bound entry, (nf - 1) per eval
    point and message pair (T/2 pairs, T/4 after a bind first)."""
    pairs = T // 2
    bind, msg = order != "message", order != "bind"
    n_bytes = 32 * nf * T + 32 * bind + (32 * nf * pairs if bind else 0) \
        + ((64 * nf * blocks + 32 * nf) if msg else 0)
    msg_pairs = pairs // 2 if order == "bind_message" else pairs
    products = nf * pairs * bind + (nf - 1) * nf * msg_pairs * msg
    return bound_ms(n_bytes, products)


# K3 (csrc/g1.cu): Fq products of each point formula (an Fq product is
# MADS_PER_PRODUCT multiply-adds, as Fr's), one Jacobian point's bytes
# (X, Y, Z) and one affine base's (X, Y)
G1_ADD_PRODUCTS = 16          # add-2007-bl, 11M + 5S
G1_MADD_PRODUCTS = 11         # madd-2007-bl, 7M + 4S
G1_DOUBLE_PRODUCTS = 7        # dbl-2009-l, 2M + 5S
# Z^(q-2): 253 squarings and 109 products, then Z^-2, Z^-3, X Z^-2, Y Z^-3
G1_NORMALIZE_PRODUCTS = 253 + 109 + 4
G1_POINT_BYTES = 96
G1_AFFINE_BYTES = 64


def k3_bound_ms(form: str, lanes: int, generic_adds: int = None,
                bits: int = 0, set_bits: int = 0, words: int = 8,
                entries: int = 0, segments: int = 0, n_seg: int = 0,
                c: int = 0) -> Tuple[float, str]:
    """One K3 call over `lanes`: its inputs read once and its outputs
    written once, and the Fq products the data needs --
      "add": 16 for each of `generic_adds` lanes (default all; an add at
        infinity needs none); "double": 7 a lane;
      "scalar_mul": 7 for each of the `bits` doublings and 16 for each of
        the `set_bits` adds, summed over the lanes;
      "normalize": `G1_NORMALIZE_PRODUCTS` for each of `generic_adds`
        finite lanes (default all);
      "bucket_sum": `lanes` affine bases, `entries` lane-list entries in
        `n_seg` segments, `segments` of them not empty: 11 for each entry
        but the first of a segment (it is a copy); the partials of the
        kernel's levels are its own and not counted;
      "bucket_reduce": `lanes` = n_win windows of 2^c buckets: the running
        sums' 2 adds a bucket, c doublings and an add a window."""
    if form == "add":
        n_bytes = 3 * G1_POINT_BYTES * lanes
        products = G1_ADD_PRODUCTS * (lanes if generic_adds is None
                                      else generic_adds)
    elif form == "double":
        n_bytes = 2 * G1_POINT_BYTES * lanes
        products = G1_DOUBLE_PRODUCTS * lanes
    elif form == "scalar_mul":
        n_bytes = (2 * G1_POINT_BYTES + 4 * words) * lanes
        products = G1_DOUBLE_PRODUCTS * bits * lanes \
            + G1_ADD_PRODUCTS * set_bits
    elif form == "normalize":
        n_bytes = 2 * G1_POINT_BYTES * lanes
        products = G1_NORMALIZE_PRODUCTS * (lanes if generic_adds is None
                                            else generic_adds)
    elif form == "bucket_sum":
        n_bytes = G1_AFFINE_BYTES * lanes + 4 * entries \
            + (16 + G1_POINT_BYTES) * n_seg
        products = G1_MADD_PRODUCTS * (entries - segments)
    elif form == "bucket_reduce":
        n_bytes = G1_POINT_BYTES * ((lanes << c) + 1)
        products = G1_ADD_PRODUCTS * (2 * (lanes << c) + lanes) \
            + G1_DOUBLE_PRODUCTS * c * (lanes - 1)
    else:
        raise ValueError(f"K3 has no form {form!r}")
    return bound_ms(n_bytes, products)


def msm_bound_ms(n: int, bits: int, c: int) -> Tuple[float, str]:
    """A Pippenger MSM of n affine bases and n `bits`-bit scalars at window
    width c: the bases and the scalars' words read once, the point written
    once; one mixed add a lane and window (11 products), then the bucket
    reduction (`k3_bound_ms("bucket_reduce")`).  2^20 x 254 bits at c = 8:
    ~6.1 ms of products."""
    n_win = (bits + c - 1) // c
    n_bytes = (G1_AFFINE_BYTES + 4 * ((bits + 31) // 32)) * n \
        + G1_POINT_BYTES
    products = G1_MADD_PRODUCTS * n * n_win \
        + G1_ADD_PRODUCTS * (2 * (n_win << c) + n_win) \
        + G1_DOUBLE_PRODUCTS * c * (n_win - 1)
    return bound_ms(n_bytes, products)


# K4 (csrc/transcript.cu): one Blake2b compression is 12 rounds of 8 G
# functions, each 6 additions, 4 xors and 4 rotations of 64-bit words: two
# 32-bit operations each, counted at the multiply-add rate
OPS_PER_COMPRESSION = 12 * 8 * 14 * 2


def k4_bound_ms(degrees, active, n_c: int) -> Tuple[float, str]:
    """One K4 launch (a round's tail) over instances of `degrees`, those
    flagged in `active` sending messages, with `n_c` compressed
    coefficients: each active instance's evals, every claim, batching
    coefficient and the state read once, the claims, coefficients,
    challenge and state written once; the products the round needs --
    the coefficient recovery (0, 1, 2 at degree 1, 2, 3; one halving for an
    inactive instance), one scaling per coefficient and the Horner steps,
    a canonical conversion per compressed coefficient and the challenge's
    to Montgomery form -- and 2 + n_c compressions.  Bound by neither:
    the kernel is a chain of dependent steps (latency)."""
    n = len(degrees)
    coefs = [d + 1 if a else 1 for d, a in zip(degrees, active)]
    n_bytes = (32 * sum(d for d, a in zip(degrees, active) if a)
               + 32 * 3 * n + 36 * 2 + 32 * (n_c + 1))
    products = (sum(d - 1 if a else 1 for d, a in zip(degrees, active))
                + sum(coefs) + sum(c - 1 for c in coefs) + n_c + 1)
    return bound_ms(n_bytes, products, OPS_PER_COMPRESSION * (2 + n_c))
