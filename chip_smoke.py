"""Smoke run of the torch port on one NVIDIA GPU (H100): builds the port's
CUDA kernels from this checkout, holds each against its plain PyTorch
version, drives the port's main path once at full size, and checks it.

    python3 chip_smoke.py [--old-k4 TREE]

(`--old-k4`: an unpacked tree of commit c3a2d92, whose one-warp K4
phase 4b times beside this one; with no argument it times this K4 alone.)

Phases:
  1. the card (nvidia-smi name and power limit) and the host (CPU model,
     nproc: tier 2, phase A and the Fr folds of Dory are host work);
  2. build K1 (`jolt_tpu_torch/csrc/mont_mul.cu`), K2
     (`jolt_tpu_torch/csrc/product_round.cu`), K3
     (`jolt_tpu_torch/csrc/g1.cu`) and K4
     (`jolt_tpu_torch/csrc/transcript.cu`), one nvcc for sm_90a each, and
     the Dory pairing library (`jolt_tpu_torch/csrc/pairing.cpp`, g++), all
     at once; ptxas's registers and spills; then the Dory setup of the main
     path (2^26: nu = 10, sigma = 16), generated or loaded from the port's
     cache, with its seconds;
  3. K1 (`mont_mul.cu`, the elementwise Fr kernel) vs its plain version on
     the card, bit for bit, in each of its six forms (mul, add, sub, bind
     of halves and of pairs, evals, reduce with and without a scale):
     seeded inputs at N = 2^20, the values 0, 1 and r-1, and a 512-element
     sample against Python ints; each form's kernel-only time at 2^20
     (torch.profiler, on inputs that come from HBM: `cold_copies`) with
     the columns a thread chosen by size and forced to 1 and to 2, beside
     its bound and its plain version's time; the same at a product by a
     scalar and a bind of 2^17-2^19 outputs;
  4. K2 vs `product_round_plain` on the card, bit for bit, for 2 and 3
     factors in each pass order (message then bind, message alone, bind
     then message, bind alone): seeded inputs at T = 2^14 and 2^18, the
     values 0, 1 and r-1 (factors and challenge), and T = 8 against Python
     ints; the challenge as a device scalar (read by the kernel by pointer)
     against the same challenge by value, in every order; then per order
     at 2^18 the kernel-only times (torch.profiler) of the pass kernel and
     of the on-card finish of the message, the time of the wrapper that
     launches both (CUDA events, host cost included) with r by value and
     with r a device scalar, and that of the plain version, with the
     bound;
  4b. K4 (the round tail of the device tier) vs its plain version
     (`transcript/device.round_tail_plain`) on the card, bit for bit,
     after every round of seeded stages of 1-4 instances of degrees 1-3
     with inactive rounds, claims 0 and p-1, edge evals and starting
     states from a real transcript (one of them with a squeeze whose top
     three bits are set), and of 33, 47 and 64 instances (1, 2 and 3
     compressed coefficients); K4's time per launch (kernel-only and
     through its wrapper) at stage 1's and 1s's shapes and at 2, 8, 33
     and 64 instances beside its bound (and the one-warp K4's, with
     --old-k4), its plain version's time at stage 1's and 1s's shapes;
     its parts from clock64 stamps (its build with the hooks of
     `experiments/k4_parts.cu`), a compression's, a product's and a
     dependent ALU instruction's cycles, an empty launch, and its
     dependent-chain floor; ptxas must report no stack frame and no
     spills for K4;
  5. the round-step path (`sumcheck.product.round_step`, the counterpart of
     the JAX package's round-step entry point): 18 chained rounds from
     T = 2^18 down to 2 with seeded challenges, K2's launch count read
     around them, every round held against the plain version; then a
     chained `ProductSumcheck` of three factors at 2^18 through the batched
     engine (K2's live-round orders), every message and the final claims
     held against the plain chain;
  6. the main path: the sha2-chain guest (chain=114, ~2^18 cycles) traced
     by the port's native tracer, `prove(trace, setup=setup,
     device="cuda")` (the stage-0 Dory commits and the stage-8 Dory
     opening with their G1 work on K3 -- one-hot tier 1, the dense
     commits, phase B's MSMs and Gamma1 folds -- and their pairings and Fr
     folds on the host, stages 1-8 on the card; its end-to-end cycles/s
     and Dory's spans) with K1's launch count per form and K2's and K3's
     read around it, and per stage (the Dory stages launch K3 and no K1
     or K2; K2 carries the shift sumcheck,
     stage 1s, every ra-virtualization instance of stage 6v -- log2 T + 1
     calls each -- the cycle rounds of stage 7's Hamming-weight instances
     and stage 8's one-hot groups, and stage 8's dense openings), every
     K1 launch's shapes recorded (`kernels.record`) and no call of the
     plain versions' limb arithmetic, then `verify(..., setup=setup)`; the
     same prove with Dory's G1 work on the native library (the route
     argument of `DoryScheme`) gives the same proof bytes and FS tape,
     with its Dory stage seconds and spans beside the K3 route's; a
     third `prove`, at `setup=None` so its per-stage device numbers
     compare with the runs before Dory, under torch.profiler gives each
     stage's device time and busy share
     and counts the device kernels that are neither K1 nor K2; then each
     K1 form vs plain again at the largest launch shape of that run and at
     the one with the most work (launches x bound), with kernel-only times
     and bounds; every batched stage but s5i takes the device tier in the
     main run (`sumcheck/fused.py`: in each, K4 launched once a round of
     its longest instance -- the rounds formula, which the proof's round
     polynomials must also give --, one device-to-host fetch a stage, ten
     in all, no synchronizing CUDA call from a stage's first message to
     its fetch, under the sync debug mode) and the host engine in the
     native-route run (every slot forced there through the backend seam,
     `with_tier(slot, "host")`, no K4), whose proof bytes and FS tape are
     the same and whose K1 and K2 launches are the same stage by stage;
     both tiers' seconds a stage, the device tier's spans a stage, and
     each stage's busy share on the device tier from a profiled run at
     setup=None;
  6b. the zk and committed-image paths at full width: the same trace and
     setup through `prove(..., zk=True, zk_rng=random.Random(SEED))` and
     `prove(..., committed_image=True)`, each with its launch counts set to
     0 just before and read just after; every one of the 11 batched
     stages carries round commitments and no clear polynomial, and the zk
     run launches K1 (per form, per stage), K2 and stage 0's K3 exactly
     as the plain run did, and no K4 (its stages take the host engine's
     committed rounds); the image run launches K4 stage by stage as the
     plain run (its stage 7, the image's reduction in it, on the device
     tier) and K2 as the plain run plus the image's
     two instances (its stage-7 reduction and its stage-8 dense opening,
     log2(image words) + 1 calls each) and K1 as the plain run outside
     stages 7 and 8; each path's cycles/s, stage seconds beside the plain
     run's, BlindFold's seconds, the round commitments' seconds (the
     `zk.commit` span), and `verify`'s seconds (the image's with and
     without its cached trusted commitment);
  6c. stage 1's streaming tier (`[stream]` lines): the main path's
     `prove` again, forced to stream (`_stream_stage1=True`: four chunks
     of 2^16 cycles), with its launch counts set to 0 just before it and
     read just after: the main run's proof bytes and FS tape, one fetch a
     device-tier stage and no synchronizing call from a stage's first
     message to its fetch (s1's streamed openings included), K4 as the
     main run; stage 1's seconds and its own peak allocated memory (reset
     as its uni-skip round starts, read at its end) beside the main
     run's.  Then the sha2-chain at `SHA2_CHAIN_2_20` (1,028,514 cycles,
     padded 2^20) through `prove(setup=None, device="cuda")`, which
     streams unforced (16 chunks), and `verify`: each stage's seconds and
     K1 launches, stage 1's peak and the whole `prove`'s;
  6d. the cycle mesh (`[mesh]` lines, `parallel/mesh.py`): (a) the main
     path's `prove` again under `use_mesh(cycle_mesh(1))`, one rank over
     NCCL in this process, its launch counts set to 0 just before it and
     read just after: the main run's bytes and FS tape, K4 0 and every
     stage on the host engine, K1 / K2 per stage, its seconds and peak;
     the chain=1 trace at D = 1 under `CommDebugMode`, the collectives by
     kind and stage; (b) two ranks on this one card over gloo (spawned): which
     of DTensor's collectives gloo carries on CUDA tensors (all-gather,
     all-reduce, all-to-all, each on ranks of its own), then, where it
     carries the prove's, the chain=1 trace's proof on each rank == the
     D = 1 proof, K1 launched on both; the one refusal seen (the
     all-gather ending a rank with SIGSEGV, the all-reduce right) is
     named on a `[mesh] (b) REFUSED` line, any other result fails;
  7. card vs CPU: `prove` on the small fib trace gives the same
     `proof_io.serialize_proof` bytes on "cuda" and on "cpu" (stages 1-8;
     fib's RAM and bytecode spaces fit one chunk, so it has no stage-6v
     instance), and one `RaVirtual` instance (d = 2) on seeded chunks
     gives identical round polynomials, openings and transcripts on both;
     fib with `zk=True, zk_rng=random.Random(42)` and the image guest
     (a guest that reads its own code, so its RAM space holds the image)
     with `committed_image=True` give the same bytes on both and verify;
     `zk=True` with `committed_image=True` raises on the card too;
  7b. the alternative tiers (`[a19]` lines), on fib and on the
     sha2-chain at chain=1: `Booleanity`, `HammingWeight` and
     `SparseOneHotOpening` over each trace's register, bytecode and RAM
     index streams as one stage, on the card's device tier (one K4 launch
     a round, no synchronizing call in the loop) == the card's host
     engine == the CPU; the dense Twist provers (registers and RAM) card
     == CPU on fib (at chain=1 their CPU side alone takes minutes: K x T
     = 2^19 register and 2^25 RAM entries); the naive interpreter == a
     `DenseOpening` on the card;
  7c. the entry point (`[cli]` lines): `python -m jolt_tpu_torch.cli prove
     examples/fibonacci.s` in a subprocess with the default device (the
     card), then `cli verify` prints its accept line, and the proof file's
     bytes equal `prove(trace, device="cuda")`'s in this process;
  8. card vs CPU: one seeded booleanity and one Hamming-weight
     `GroupedOneHot` of 18 members at K = 256 and T = 2^14 (stage 7's
     largest group) give identical round polynomials, openings and
     transcripts on both; the whole proof of a small guest with a Dory
     setup (13 variables) has the same bytes and FS tape on both (Dory's
     G1 work on K3 on the card, on the native library on the CPU), and
     verifies, and so do the guest with zk and the image guest with the
     committed image at the same setup;
  8b. K3, the G1 kernel (`[g1]`, `[msm]` and `[kzg]` lines): every form
     bit for bit against its plain version with edge lanes -- add and
     double at 2^20 lanes (P + P, P + (-P), infinities, equal points in
     other coordinates), a 254-bit scalar_mul at 2^15 (the Dory
     opening's first Gamma1 fold: one scalar), normalize at 2^20,
     bucket_sum of a 2^20 commit's windows and of edge segments (every
     lane in one, P + P, P + (-P), infinity bases, one lane, none) and
     bucket_reduce of its buckets -- each form's time (CUDA events;
     bucket_sum's and bucket_reduce's launches alone, their whole calls
     apart) beside its bound, its plain version's and the first K3's
     (PERF.md, PR 9); the 2^20 MSM
     against the host's; the 2^20 KZG setup (one scalar_mul, one
     normalize; 128 powers == [tau^i] G1, affine); the whole MSM at
     2^9 .. 2^22 lanes and every window width c = 4 .. 16, beside the one
     `g1.window_bits` picks; one 2^20 commit from device words and one from Python
     ints, one 2^22 commit, with their peaks; the KZG `prove` of the sha2-chain at chain=1 (2^20 SRS)
     with K3's counts set to 0 just before it and read just after, its
     stage seconds, K3 launches per form and stage, its MSMs by lane
     count, the HyperKZG spans,
     peak memory and `verify`; one dense commitment against the host MSM;
     card == CPU proof bytes with a 2^13 KZG setup on the PCS guest; and
     Dory's one-hot tier 1 on the K3 route (one bucket_sum over the rows)
     on the main path's 23 matrices against the native route's segment
     sums, that bucket_sum alone against its plain version and timed
     (K3's headline), and Gamma1's pack to the card timed alone;
  9. one JSON line with every ported kernel (K3's launches are the Dory
     prove's, by stage and form; K4's the main run's), the card line, and
     the final
     `{"ok": true, "device": ...}` line.

Any failure raises and exits nonzero; with no CUDA device it exits 2
before printing any result.  Nothing runs on the Python pairing tier:
with JOLT_TPU_NO_NATIVE_PAIRING set the script fails.
"""

import argparse
import collections
import contextlib
import itertools
import json
import math
import os
import pathlib
import random
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 1234

K2_LOG_T = 18                # K2's full size: the main path's 2^18
K2_SMALL_LOG_T = 14          # the round-step entry point's own size
# the stages of `prove` at setup=None (the profiled run), and with Dory (the
# main path): stage 0's commits and the joint opening after stage 8
STAGES = ["witness-extraction", "stage1-spartan", "stage1s-shift",
          "stage2-reg-rw", "stage3-reg-val", "stage4-5-ram",
          "stage5i-instr-lookups", "stage6-bytecode", "stage6v-ra-virtual",
          "stage7-booleanity", "stage8-reduction"]
DORY_STAGES = (STAGES[:1] + ["stage0-commit"] + STAGES[1:]
               + ["stage8-openings"])
# the spans of the Dory commits (`prover/prover.py` stage 0, and each
# commitment's tier 1 and tier 2 in `pcs/dory.py`) and of the opening
# (`pcs/dory.py`, `pcs/scheme.py`)
DORY_SPANS = ["commit.onehot", "commit.dense", "commit.tier1",
              "commit.tier2", "open.rlc_rows", "open.e1", "open.A.v2init",
              "open.A.pair", "open.A.g1fold", "open.A.g2fold", "open.B.row",
              "open.B.msm", "open.B.g1fold"]
# the small guest proven with Dory card against CPU (phase 8): the JAX
# package's Dory pipeline guest, 2^13 variables (256 x 32)
DORY_SMALL_VARS = 13
DORY_SMALL = """
    li   a1, 21
    li   a2, 34
    add  a3, a1, a2
    xor  a4, a1, a2
    and  a5, a3, a4
    add  a3, a3, a5
    li   t0, {output_start}
    sd   a3, 0(t0)
    li   t1, {termination}
    li   t2, 1
    sd   t2, 0(t1)
"""
# a guest that loads two words of its own code through RAM, so its RAM
# address space holds the program image (the committed-image card vs CPU
# runs of phases 7 and 8; the JAX package's tests/test_program_image.py)
IMAGE_GUEST = """
    li   t0, 0x80000000
    ld   a1, 0(t0)
    ld   a2, 8(t0)
    add  a3, a1, a2
    li   t1, {output_start}
    sd   a3, 0(t1)
    li   t2, {termination}
    li   t3, 1
    sd   t3, 0(t2)
"""
# the device tier's spans (`sumcheck/fused.py`)
FUSED_SPANS = ["fused.rounds", "fused.fetch", "fused.replay"]
# the batched stages' labels (zk round commitments), in `prove`'s order
ZK_LABELS = ["s1", "s1s", "s2", "s3", "s4", "s5", "s5i", "s6", "s6v", "s7",
             "s8"]
CLEAR_POLYS = ["stage1_polys", "shift_polys", "stage2_polys", "stage3_polys",
               "stage4_polys", "stage5_polys", "stage5i_polys",
               "stage6_polys", "stage6v_polys", "stage7_polys",
               "stage8_polys"]
# the d = 2 ra-virtualization instance held card against CPU (phase 7)
RA_VIRTUAL_LOG_T = 14
RA_VIRTUAL_LOG_K = 13
# the grouped one-hot instances held card against CPU (phase 8): stage 7's
# largest group on the main path (16 instruction chunks and the 8-bit RAM
# and bytecode chunks at K = 256)
ONEHOT_LOG_T = 14
ONEHOT_M = 18
ONEHOT_K = 256
# K3 held against its plain version (phase 8b): add and double at 2^20
# lanes with G1_EDGE lanes of each edge case, scalar_mul at 2^15 lanes
# (the Dory opening's first Gamma1 fold: Gamma1's low half of the 2^26
# setup, one 254-bit scalar for every lane); the KZG setup of the
# sha2-chain at chain=1 (2^12 cycles x 2^8)
G1_LOG_N = 20
G1_EDGE = 64
G1_SCALAR_LOG_N = 15
KZG_LOG_N = 20
# the MSM's lane counts (log2) timed at every window width (phase 8b);
# the first K3's times in ms, printed beside the new ones (one thread a
# lane, points through a stack frame, generic adds: PERF.md's findings on
# the first K3, H100 80GB HBM3, 700.00 W; add and double at 2^20 lanes
# and the setup's scalar_mul of 2^20 x 254 bits)
MSM_SWEEP_LOG_N = range(9, 23)
# the seeded stages K4 is held against its plain version on (phase 4b):
# tests/test_torch_cuda.py's `k4_case` (seeds 0-11, 1-4 instances; seed 5
# squeezes a challenge with the top three bits of its 128 set) and its
# wide stages `K4_WIDE` (33, 47 and 64 instances)
K4_SEEDS = 12
FIRST_K3_MS = {"add": 0.8101, "double": 0.2497, "scalar_mul_setup": 264.34}

FIB_LAYOUT = dict(max_input_size=64, max_output_size=64)
FIB = """
    li   a0, 20
    li   a1, 0
    li   a2, 1
loop:
    beq  a0, zero, done
    add  a3, a1, a2
    mv   a1, a2
    mv   a2, a3
    addi a0, a0, -1
    j    loop
done:
    li   t0, {output_start}
    sd   a1, 0(t0)
    li   t1, {termination}
    li   t2, 1
    sd   t2, 0(t1)
"""


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rand_field(shape, gen, device):
    """Seeded random canonical-range limb tensor (8, *batch) (< p)."""
    w = torch.randint(0, 1 << 32, (8,) + tuple(shape[1:]), generator=gen,
                      device=device, dtype=torch.int64)
    w[7] %= 0x30644E72                      # top limb of p: value < p
    return (w - ((w >> 31) << 32)).to(torch.int32)


def ints_to_words(vals, device):
    """Python ints (< 2^256) -> (8, n) int32 words, little-endian."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    w = np.frombuffer(raw, dtype="<u4").reshape(-1, 8).T
    return torch.from_numpy(np.array(w, dtype=np.uint32).view(np.int32)).to(device)


def words_to_ints(t: torch.Tensor):
    arr = t.reshape(8, -1).cpu().numpy().astype(np.uint32).T
    raw = np.ascontiguousarray(arr).astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
            for i in range(arr.shape[0])]


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rand_sums(shape, gen, device):
    """Seeded int64 limb-plane sums (8, *batch) in the range the column sums
    of the path reach (each plane < 2^62, the top one < 2^61, so the carry
    out above 2^256 stays below 2^32)."""
    w = torch.randint(0, 1 << 62, tuple(shape), generator=gen, device=device,
                      dtype=torch.int64)
    w[7] >>= 1
    return w


def k1_args(form, key, draw, draw_int, draw_sums):
    """Operands for K1's `form` as a launch record's key describes them
    (`kernels.record`): shapes, "int" for a value passed by value, and
    bind's and evals' layout of (lo, hi) -- the "high" and "low" halves of
    one tensor, or "split"."""
    def pair(shape, layout):
        *batch, h = shape
        if layout == "split":
            return draw(shape), draw(shape)
        P = draw(tuple(batch) + (2 * h,))
        if layout == "high":
            return P[..., :h], P[..., h:]
        return P[..., 0::2], P[..., 1::2]
    if form in ("mul", "add", "sub"):
        return tuple(draw_int() if s == "int" else draw(s) for s in key)
    if form == "bind":
        lo_shape, layout, r = key
        return (*pair(lo_shape, layout), draw_int() if r == "int" else draw(r))
    if form == "evals":
        lo_shape, degree, layout = key
        return (*pair(lo_shape, layout), degree)
    cols, scale = key
    return (draw_sums(cols), None if scale is None
            else draw_int() if scale == "int" else draw(scale))


def k1_call(kernels, form, args):
    return {"mul": kernels.mont_mul, "add": kernels.add, "sub": kernels.sub,
            "bind": kernels.bind, "evals": kernels.evals,
            "reduce": kernels.reduce}[form](*args)


def k1_plain(kernels, form, args):
    """The plain version of `form` on the same operands (an int operand as
    its Montgomery limbs)."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    nb = max(a.dim() for a in args if isinstance(a, torch.Tensor)) - 1

    def t(x):
        return kernels._plain_operand(x, dev, nb)
    if form in ("mul", "add", "sub"):
        plain = {"mul": kernels.mont_mul_plain, "add": kernels.add_plain,
                 "sub": kernels.sub_plain}[form]
        return plain(t(args[0]), t(args[1]))
    if form == "bind":
        return kernels.bind_plain(args[0], args[1], t(args[2]))
    if form == "evals":
        return kernels.evals_plain(*args)
    return kernels.reduce_plain(args[0],
                                None if args[1] is None else t(args[1]))


def k1_python(kernels, form, args, shape):
    """K1's function on Python ints over the raw Montgomery words: the
    output's words as ints, in the output's (8, ...) order."""
    P, r_inv = kernels.P, pow(1 << 256, -1, kernels.P)

    def vals(x):
        if not isinstance(x, torch.Tensor):
            return [x % P * (1 << 256) % P] * math.prod(shape[1:])
        return words_to_ints(x.expand(shape).contiguous())
    if form == "reduce":
        cols, scale = args
        raw = cols.reshape(8, -1).cpu().tolist()
        S = [sum(raw[l][j] << (32 * l) for l in range(8)) % P
             for j in range(len(raw[0]))]
        if scale is None:
            return S
        return [s * c * r_inv % P for s, c in zip(S, vals(scale))]
    a, b = vals(args[0]), vals(args[1])
    if form == "mul":
        return [x * y * r_inv % P for x, y in zip(a, b)]
    if form == "add":
        return [(x + y) % P for x, y in zip(a, b)]
    if form == "sub":
        return [(x - y) % P for x, y in zip(a, b)]
    if form == "bind":
        return [(x + (y - x) * r * r_inv) % P
                for x, y, r in zip(a, b, vals(args[2]))]
    return [v for k in range(args[2]) for v in
            ([x for x in a] if k == 0 else
             [(y + k * (y - x)) % P for x, y in zip(a, b)])]


def compare_k1(kernels, form, args, where):
    """K1 vs its plain version on the card; returns max |difference| over
    the words (0, or the check fails)."""
    got = k1_call(kernels, form, args)
    want = k1_plain(kernels, form, args)
    torch.cuda.synchronize()
    check(got.shape == want.shape,
          f"K1 {form} shape {tuple(got.shape)} vs {tuple(want.shape)} {where}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0 and torch.equal(got, want),
          f"K1 {form} disagrees with its plain version {where}")
    return err


def time_k1(kernels, form, args, key):
    """K1's `form` in ms: kernel-only (torch.profiler) with the columns a
    thread chosen by size as on the main path, and with one and two forced
    (`force_k1_columns`; bit-equal checked); the plain version (CUDA
    events); and the bound of the launch `key`."""
    from jolt_tpu_torch.workload import k1_bound_ms
    sets = cold_copies(args)
    name = f"k1_{form}"
    t = {}
    for v in (0, 1, 2) if form != "reduce" else (0,):
        kernels.force_k1_columns(v)
        try:
            if v:
                compare_k1(kernels, form, args, f"at {key}, V = {v}")
            t[f"ms_v{v}" if v else "ms"] = kernel_ms(
                lambda *a: k1_call(kernels, form, a), sets, (name,))[name]
        finally:
            kernels.force_k1_columns(0)
    del sets
    bound, by = k1_bound_ms(form, key)
    return {**t, "plain_ms": cuda_ms(lambda: k1_plain(kernels, form, args), 3),
            "bound_ms": bound, "bound_by": by}


def k1_line(form, key, t, tag=""):
    """One printed line of a K1 timing (`time_k1`)."""
    alt = "".join(f", V = {k[-1]}: {t[k]:.5f}" for k in ("ms_v1", "ms_v2")
                  if k in t)
    return (f"[kernel] K1 {form} {tag}{key}: {t['ms']:.5f} ms kernel-only "
            f"(V by size{alt}), plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"{t['bound_ms'] / t['ms']:.0%} of the bound")


def k2_error(got, want, where):
    """Max |difference| over the words of K2's outputs (msg, bound) vs the
    plain version's; fails unless they are identical."""
    (msg, bound), (want_msg, want_bound) = got, want
    pairs = [(msg, want_msg)] if want_msg is not None else []
    check((msg is None) == (want_msg is None)
          and (bound is None) == (want_bound is None),
          f"K2 outputs {where}")
    pairs += list(zip(bound or (), want_bound or ()))
    err = 0
    for g, w in pairs:
        check(g.shape == w.shape, f"K2 shape {g.shape} vs {w.shape} {where}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()))
        check(torch.equal(g, w), f"K2 disagrees with plain {where}")
    return err


def k2_python_ints(kernels, ops, polys, r, order):
    """K2's function on Python ints: (message evals, bound factors)."""
    P = kernels.P
    vals = [ops.unpack_ints(p) for p in polys]
    rv = ops.unpack_ints(r)[0]
    nf = len(polys)

    def bind(v):
        h = len(v) // 2
        return [(v[i] + rv * (v[i + h] - v[i])) % P for i in range(h)]

    def message(vs):
        h = len(vs[0]) // 2
        out = []
        for x in [0] + list(range(2, nf + 1)):
            total = 0
            for i in range(h):
                prod = 1
                for v in vs:
                    prod = prod * (v[i] + x * (v[i + h] - v[i])) % P
                total += prod
            out.append(total % P)
        return out

    bound = [bind(v) for v in vals] if order != "message" else None
    if order == "bind":
        return None, bound
    return message(bound if order == "bind_message" else vals), bound


L2_BYTES = 50 << 20          # the H100's L2


def cold_copies(args):
    """`args` and enough copies of its tensors that cycling through them
    reads three times the L2 before one comes round again, so each call
    finds its inputs in HBM (as the main path mostly does) and, in the
    steady state, pays for the last call's writes leaving the L2.  Views of
    one tensor stay views of one copy (bind's halves and pairs keep their
    layout)."""
    storages = {}
    for a in args:
        if isinstance(a, torch.Tensor):
            storages[a.untyped_storage().data_ptr()] = a.untyped_storage()
    size = sum(st.nbytes() for st in storages.values())
    sets = [tuple(args)]
    for _ in range(1, math.ceil(3 * L2_BYTES / max(size, 1))):
        new = {k: st.clone() for k, st in storages.items()}
        sets.append(tuple(
            torch.empty(0, dtype=a.dtype, device=a.device).set_(
                new[a.untyped_storage().data_ptr()], a.storage_offset(),
                a.shape, a.stride())
            if isinstance(a, torch.Tensor) else a for a in args))
    return sets


class ProfilerLost(SmokeFailure):
    """The profiler's traces kept fewer than 3 launches of a kernel."""


def kernel_ms(fn, arg_sets, names, reps=20, tries=4):
    """Mean device time of each kernel whose name holds one of `names`
    (each launched once a call), kernel-only: torch.profiler over `reps`
    calls fn(*args), cycling through `arg_sets` (`cold_copies`), after a
    warm-up, so neither the host's cost of the calls nor cached inputs are
    in it.  The profiler may lose launches: a trace with fewer than half of
    each is taken again, and after `tries` the mean is over the launches
    all the traces held if they hold at least 3 of each (said in a line).
    Else one name is timed by `k4_parts.queued_ms` (the call's whole device
    time, said in a line), and more than one raise `ProfilerLost`."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    pooled = {name: [] for name in names}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*arg_sets[i % len(arg_sets)])
            torch.cuda.synchronize()
        seen = {name: [] for name in names}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                for name in names:
                    if name in e.name:
                        seen[name].append(e.time_range.elapsed_us())
        if 2 * min(len(us) for us in seen.values()) >= reps:
            return {name: sum(us) / len(us) / 1e3
                    for name, us in seen.items()}
        for name, us in seen.items():
            pooled[name] += us
    counts = {n: len(us) for n, us in pooled.items()}
    if min(counts.values()) >= 3:
        print(f"[timing] the profiler kept {counts} of {tries * reps} "
              f"launches in {tries} traces; the mean is over those",
              flush=True)
        return {name: sum(us) / len(us) / 1e3 for name, us in pooled.items()}
    if len(names) > 1:
        raise ProfilerLost(f"the profiler lost launches of {names}: "
                           f"{counts} of {tries * reps}")
    import k4_parts
    step = itertools.count()
    ms = k4_parts.queued_ms(lambda: fn(*arg_sets[next(step) % len(arg_sets)]),
                            reps)
    print(f"[timing] the profiler kept {counts} of {tries * reps} launches "
          f"in {tries} traces; timed instead by CUDA events over {reps} "
          "calls queued behind a sleep kernel (the call's whole device time)",
          flush=True)
    return {names[0]: ms}


def events_ms(fn, arg_sets, reps):
    """Mean device time of fn(*args) in ms by CUDA events over `reps`
    back-to-back calls cycling through `arg_sets`, after a warm-up: for
    kernels of a millisecond and more, whose wrapper's host cost hides
    behind the kernel before it."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k3_bucket_sum_ms(g1, A, segs, reps):
    """K3 bucket_sum's launches alone in ms, against `g1.bucket_sum`'s
    whole call: the chunk tables of every level made first
    (`g1.bucket_levels`, the torch plumbing with its host syncs), then
    CUDA events around each level's launch, summed over the levels; the
    mean over `reps` sums after a warm-up.  Returns (kernel ms, levels)."""
    lanes, starts, ends = segs
    starts = starts.to(torch.int64)
    levels = g1.bucket_levels(starts, (ends - starts).clamp_min(0))
    rows = g1._base_rows(A)
    lanes = lanes.to(torch.int32).contiguous()

    def run():
        parts, spans = rows, []
        for i, (beg, end) in enumerate(levels):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            parts = g1._sum_level_k3(parts, i == 0, lanes if i == 0
                                     else None, beg, end)
            ev[1].record()
            spans.append(ev)
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans)
    run()
    return sum(run() for _ in range(reps)) / reps, len(levels)


def k3_bucket_reduce_ms(g1, B, c, reps):
    """K3 bucket_reduce's launch alone in ms: its buffers made and its
    ticket counter zeroed outside the CUDA events; the mean over `reps`
    launches after a warm-up."""
    B = tuple(x.contiguous() for x in B)
    work = g1.reduce_buffers(B[0].shape[1] >> c, B[0].device)
    total = 0.0
    for i in range(reps + 1):
        work[2].zero_()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        g1._reduce_k3(B, c, *work)
        ev[1].record()
        ev[1].synchronize()
        total += ev[0].elapsed_time(ev[1]) if i else 0.0
    return total / reps


def msm_width_sweep(g1, A, words, log_ns, reps=3):
    """The Pippenger MSM from device words (`g1.msm_pippenger`, the whole
    call: digits, sort, offsets, bucket_sum, bucket_reduce) at 2^L lanes
    for each L in `log_ns`, the bases and words the first 2^L lanes of A
    and `words`, at each window width c from 4 to min(16, L), by CUDA
    events (one clock for every cell); with the fastest c and the one
    `g1.window_bits` picks.  Returns {L: {"ms": {c: ms}, "best_c": c,
    "window_bits": c}}."""
    from jolt_tpu_torch.workload import msm_bound_ms
    out = {}
    for L in log_ns:
        n = 1 << L
        P = tuple(x[:, :n] for x in A)
        w = words[:, :n].contiguous()
        ms = {c: events_ms(lambda *a: g1.msm_pippenger(P, a[0], 254, c),
                           [(w,)], reps)
              for c in range(4, min(16, L) + 1)}
        best = min(ms, key=ms.get)
        pick = g1.window_bits(n)
        out[L] = {"ms": ms, "best_c": best, "window_bits": pick,
                  "bound_ms": msm_bound_ms(n, 254, best)[0]}
        print(f"[msm] 2^{L} x 254 bits by window width (ms, CUDA events, "
              "from device words): "
              + ", ".join(f"c={c} {t:.4f}" for c, t in ms.items())
              + f"; fastest c = {best}; window_bits picks c = {pick}, "
              f"{ms[pick] / ms[best] - 1:+.1%} over the fastest; bound at "
              f"c = {best} {out[L]['bound_ms']:.4f} ms", flush=True)
    return out


def time_k4(k4p, dt, dev, old_lib=None):
    """K4 at each shape of `k4_parts.SHAPES` (stage 1's round, stage 1s's,
    and 2, 8, 33 and 64 instances): kernel-only ms a launch
    (torch.profiler) and the wrapper's ms a launch back to back (CUDA
    events, its host cost included), twice; with `old_lib` (the one-warp
    K4 built from its tree) the one-warp K4 through a copy of its
    wrapper beside it, in turns old, new, new, old; the bound
    (`workload.k4_bound_ms`); at stage 1's and 1s's shapes the plain
    version's ms a round on the card."""
    from jolt_tpu_torch.workload import k4_bound_ms
    if old_lib is not None:
        runs = k4p.compare(old_lib, dev)
    else:
        runs = {name: {"new": [k4p.time_shape(dt.round_tail, d, dev)
                               for _ in range(2)]}
                for name, d in k4p.SHAPES}
    out = {}
    for name, degrees in k4p.SHAPES:
        n_c = dt.compressed_len([True] * len(degrees), list(degrees))
        bound, by = k4_bound_ms(list(degrees), [True] * len(degrees), n_c)
        new = runs[name]["new"]
        out[name] = {"degrees": list(degrees), "n_c": n_c,
                     "ms": min(t["ms"] for t in new),
                     "wrapper_ms": min(t["wrapper_ms"] for t in new),
                     "runs": runs[name], "bound_ms": bound, "bound_by": by}
        if name in ("s1", "s1s"):
            evals, degs, fresh, _ = k4p.shape_case(degrees, dev)
            bufs = fresh()
            out[name]["plain_ms"] = cuda_ms(
                lambda: dt.round_tail_plain(evals, degs, bufs, 0, n_c), 3)
    return out


def time_k2(kernels, ops, polys, r, order):
    """K2 in ms: its pass kernel and its finish kernel alone (kernel-only
    device time), the wrapper with both as a live round calls it
    (CUDA events over back-to-back calls with r a Python int, so the
    wrapper's host cost counts, and with r a device scalar as the device
    tier's rounds call it), and the plain version; with the bound."""
    from jolt_tpu_torch.workload import k2_bound_ms
    r_int = ops.unpack_ints(r)[0]
    names = ("round_kernel",) + (("finish_kernel",) if order != "bind"
                                 else ())
    sets = cold_copies(polys)
    try:
        dev_ms = kernel_ms(lambda *ps: kernels.product_round(ps, r_int,
                                                             order),
                           sets, names)
    except ProfilerLost as lost:
        # the pass alone (finish=False) and the whole round, each queued
        # behind a sleep kernel: the finish is their difference
        import k4_parts
        step, step2 = itertools.count(), itertools.count()
        whole = k4_parts.queued_ms(lambda: kernels.product_round(
            sets[next(step) % len(sets)], r_int, order))
        alone = k4_parts.queued_ms(lambda: kernels.launch_product_round(
            sets[next(step2) % len(sets)], r_int, order, finish=False))
        dev_ms = {"round_kernel": alone, "finish_kernel": whole - alone}
        print(f"[timing] {lost}; K2 {order} timed instead by CUDA events "
              "over calls queued behind a sleep kernel (pass alone, and "
              "the finish as the whole round less the pass)", flush=True)
    wrapper = cuda_ms(lambda: kernels.product_round(polys, r_int, order), 20)
    wrapper_dev = cuda_ms(lambda: kernels.product_round(polys, r, order), 20)
    plain = cuda_ms(lambda: kernels.product_round_plain(polys, r, order), 3)
    partial, _ = kernels.launch_product_round(polys, r_int, order,
                                              finish=False)
    blocks = 0 if partial is None else partial.shape[1]
    bound, by = k2_bound_ms(len(polys), order, polys[0].shape[-1], blocks)
    pass_ms, finish_ms = dev_ms["round_kernel"], dev_ms.get("finish_kernel",
                                                            0.0)
    return {"ms": pass_ms + finish_ms, "pass_ms": pass_ms,
            "finish_ms": finish_ms, "wrapper_ms": wrapper,
            "wrapper_dev_ms": wrapper_dev,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "blocks": blocks}


def spill_bytes(report):
    """Sum of ptxas's spill stores and loads over a build report."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill", report))


def stack_bytes(report):
    """The largest stack frame ptxas reports over a build."""
    return max([int(n) for n in re.findall(r"(\d+) bytes stack frame",
                                           report)] or [0])


def g1_kzg_phase(dev, gen, dory_setup, pcs_guest, onehot_positions,
                 card_vs_cpu):
    """Phase 8b: (a) every K3 form against its plain version, bit for bit
    (edge lanes included), and its time (CUDA events) beside its bound and
    the plain version's; the 2^20 MSM against the host's; (b) the 2^20 KZG
    setup on the card; (c) the window width sweep and the 2^20 and 2^22
    commits, their times and peaks; (d) the KZG `prove` of the sha2-chain
    at chain=1 (this slice's path: K3's counts set to 0 just before it and
    read just after) and `verify`; (e) card == CPU with a 2^13 KZG setup
    on the PCS guest; (f) Dory's one-hot tier 1 at the main path's 2^18
    trace, the K3 route against the native route, and its bucket_sum
    alone against the plain version and timed (K3's headline).  Returns
    the kernel line's "g1" entry."""
    import tempfile

    from jolt_tpu_torch import PublicIO, prove, verify
    from jolt_tpu_torch.curve import bn254_host as host
    from jolt_tpu_torch.curve import g1
    from jolt_tpu_torch.field import fq, kernels
    from jolt_tpu_torch.pcs import scheme as scheme_mod
    from jolt_tpu_torch.pcs.dory import Dory
    from jolt_tpu_torch.pcs.hyperkzg import DEFAULT_TAU, HyperKZG, KZGSetup
    from jolt_tpu_torch.prover.prover import required_num_vars
    from jolt_tpu_torch.utils import profiling
    from jolt_tpu_torch.workload import (k3_bound_ms, msm_bound_ms,
                                         sha2_chain_trace, timed_stages)
    t_phase = time.perf_counter()
    R = host.R
    n = 1 << G1_LOG_N
    base = g1.pack_points([host.G1_GEN], dev)

    def rand_words(w, lanes=n, top_bits=32):
        x = torch.randint(0, 1 << 32, (w, lanes), generator=gen, device=dev,
                          dtype=torch.int64)
        x[-1] &= (1 << top_bits) - 1
        return (x - ((x >> 31) << 32)).to(torch.int32)

    def max_err(got, want):
        return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(got, want))

    def launched(fn):
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, {f: k for f, k in kernels.k3_launches().items() if k}

    # (a) K3 vs plain.  add and double at 2^20 lanes: random points of
    # general Z (a 64-bit scalar multiple of G per lane), against a second
    # batch with edge lanes
    P = g1.batch_scalar_mul(tuple(c.expand(-1, n) for c in base),
                            rand_words(2), 64)
    Q = [c.clone() for c in g1.jacobian_double(
        tuple(c.roll(1, 1) for c in P))]
    e = G1_EDGE
    for c, pc in zip(Q, P):                       # P + P
        c[:, :e] = pc[:, :e]
    Q[0][:, e:2 * e] = P[0][:, e:2 * e]           # P + (-P)
    Q[1][:, e:2 * e] = fq.sub_plain(torch.zeros_like(P[1][:, e:2 * e]),
                                    P[1][:, e:2 * e])
    Q[2][:, e:2 * e] = P[2][:, e:2 * e]
    P[2][:, 2 * e:3 * e] = 0                      # P at infinity, X, Y kept
    Q[2][:, 3 * e:4 * e] = 0                      # Q at infinity
    P[2][:, 4 * e:5 * e] = 0                      # both
    Q[2][:, 4 * e:5 * e] = 0
    # the same point as P in other coordinates: (l^2 X, l^3 Y, l Z)
    lam = fq.pack_ints([0x1234567], dev)
    lam2 = fq.mont_mul_plain(lam, lam)
    sl = slice(5 * e, 6 * e)
    Q[0][:, sl] = fq.mont_mul_plain(P[0][:, sl], lam2)
    Q[1][:, sl] = fq.mont_mul_plain(P[1][:, sl],
                                    fq.mont_mul_plain(lam2, lam))
    Q[2][:, sl] = fq.mont_mul_plain(P[2][:, sl], lam)
    Q = tuple(Q)
    generic = n - 6 * e
    errs = {}
    S, lk = launched(lambda: g1.jacobian_add(P, Q))
    errs["add"] = max_err(S, g1.jacobian_add_plain(P, Q))
    D, lk2 = launched(lambda: g1.jacobian_double(S))
    errs["double"] = max_err(D, g1.jacobian_double_plain(S))
    m = 1 << G1_SCALAR_LOG_N
    sub = tuple(c[:, :m] for c in dory_setup.gamma1_on(dev))
    ks = rand_words(8, lanes=1, top_bits=30).expand(8, m)     # < 2^254
    M, lk3 = launched(lambda: g1.batch_scalar_mul(sub, ks, 254))
    errs["scalar_mul"] = max_err(M, g1.batch_scalar_mul_plain(sub, ks, 254))
    # normalize at 2^20 (the setup's shape): S holds (0, 0, 0) lanes (P +
    # (-P)) and infinities with X, Y kept (both at infinity)
    A, lk4 = launched(lambda: g1.normalize(S))
    t0 = time.perf_counter()
    errs["normalize"] = max_err(A, g1.normalize_plain(S))
    p_norm = (time.perf_counter() - t0) * 1e3
    check((lk, lk2, lk3, lk4) == ({"add": 1}, {"double": 1},
                                  {"scalar_mul": 1}, {"normalize": 1}),
          f"K3 launches {lk} {lk2} {lk3} {lk4}")
    # affine spot checks against the host
    idx = [0, e, 2 * e, 3 * e, 4 * e, 5 * e, 6 * e, n - 1]
    aff = g1.unpack_points(tuple(c[:, idx] for c in S))
    pa = g1.unpack_points(tuple(c[:, idx] for c in P))
    qa = g1.unpack_points(tuple(c[:, idx] for c in Q))
    check(aff == [host.g1_add(a, b) for a, b in zip(pa, qa)],
          "K3 add differs from the host on the edge lanes")
    check(g1.unpack_points(tuple(c[:, idx] for c in A)) == aff
          and fq.unpack_ints(A[2][:, idx]) == [int(p is not None)
                                               for p in aff],
          "K3 normalize differs from the host")
    ki = words_to_ints(ks[:, :8])
    check(g1.unpack_points(tuple(c[:, :8] for c in M))
          == [host.g1_mul(p, k) for p, k in
              zip(g1.unpack_points(tuple(c[:, :8] for c in sub)), ki)],
          "K3 scalar_mul differs from the host")

    # bucket_sum at the 2^20 commit's shape: the bases A (affine, with
    # infinities), 254-bit scalars, the default window width; one window
    # batch against the plain version, then every window
    c_def = g1.window_bits(n)
    n_win = (254 + c_def - 1) // c_def
    words = rand_words(8, top_bits=30)
    segs = g1.window_segments(words, 0, n_win, c_def, 254)
    B, lk5 = launched(lambda: g1.bucket_sum(A, *segs))
    t0 = time.perf_counter()
    errs["bucket_sum"] = max_err(B, g1.bucket_sum_plain(A, *segs))
    p_bsum = (time.perf_counter() - t0) * 1e3
    # edges: one segment of every lane (equal scalars, a hot row), a point
    # twice (the mixed add doubles), a point and its negation, infinity
    # bases, a single lane, an empty segment
    Aneg = tuple(c.clone() for c in A)
    Aneg[1][:, n - 1] = fq.sub_plain(torch.zeros_like(A[1][:, n - 2:n - 1]),
                                     A[1][:, n - 2:n - 1])[:, 0]
    Aneg[0][:, n - 1] = A[0][:, n - 2]
    Aneg[2][:, n - 1] = A[2][:, n - 2]
    inf_lane = 4 * e
    edge = [list(range(n)), [7, 7], [n - 2, n - 1], [inf_lane],
            [inf_lane, 9, inf_lane], [11], []]
    e_lanes = torch.tensor(sum(edge, []), dtype=torch.int32, device=dev)
    e_offs = torch.tensor(np.cumsum([0] + [len(s) for s in edge]),
                          device=dev)
    E, lk6 = launched(lambda: g1.bucket_sum(Aneg, e_lanes, e_offs))
    errs["bucket_sum"] = max(errs["bucket_sum"], max_err(
        E, g1.bucket_sum_plain(Aneg, e_lanes, e_offs)))
    got = g1.unpack_points(tuple(c[:, 1:] for c in E))
    a7, a9 = g1.unpack_points(tuple(c[:, [7, 9]] for c in A))
    a11 = g1.unpack_points(tuple(c[:, [11]] for c in A))[0]
    check(got == [host.g1_double(a7), None, None, a9, a11, None],
          f"K3 bucket_sum's edge segments differ from the host: {got}")
    # bucket_reduce over those windows' buckets, and the MSM against the
    # host's (the native MSM of the same 2^20 points and scalars)
    Rd, lk7 = launched(lambda: g1.bucket_reduce(B, c_def))
    t0 = time.perf_counter()
    errs["bucket_reduce"] = max_err(Rd, g1.bucket_reduce_plain(B, c_def))
    p_bred = (time.perf_counter() - t0) * 1e3
    check(lk5["bucket_sum"] >= 2 and lk6["bucket_sum"] >= 3
          and lk7 == {"bucket_reduce": 1},
          f"K3 launches {lk5} {lk6} {lk7}")
    torch.cuda.synchronize()
    err = max(errs.values())
    check(err == 0, f"K3 differs from its plain version: {errs}")
    t0 = time.perf_counter()
    hp = g1.unpack_points(A)
    want = host.g1_msm_pippenger(hp, words_to_ints(words))
    t_host = time.perf_counter() - t0
    check(g1.unpack_points(Rd) == [want]
          == g1.unpack_points(g1.msm(A, words, 254)),
          "the card's 2^20 MSM differs from the host's")
    print(f"[g1] K3 == its plain version bit for bit in every form: add and "
          f"double at 2^{G1_LOG_N} lanes ({6 * e} edge lanes: P + P, "
          f"P + (-P), infinities, equal points in other coordinates), "
          f"scalar_mul of 254 bits at 2^{G1_SCALAR_LOG_N} lanes (the Dory "
          f"opening's first Gamma1 fold, one scalar), normalize "
          f"at 2^{G1_LOG_N} (infinities with X, Y kept), bucket_sum of "
          f"{n_win} windows at c = {c_def} ({lk5['bucket_sum']} levels) and "
          f"of edge segments (every lane in one, P + P, P + (-P), "
          f"infinities, one lane, none), bucket_reduce of {n_win} x "
          f"2^{c_def} buckets; host spot checks agree; the 2^{G1_LOG_N} MSM "
          f"== the host's (native, {t_host:.1f}s with the unpack)",
          flush=True)

    forms = {}
    t_add = events_ms(lambda *a: g1.jacobian_add(a[:3], a[3:]),
                      cold_copies((*P, *Q)), 20)
    t_dbl = events_ms(lambda *a: g1.jacobian_double(a), cold_copies(S), 20)
    t_smul_m = events_ms(lambda *a: g1.batch_scalar_mul(a[:3], a[3], 254),
                         [(*sub, ks)], 5)
    t_norm = events_ms(lambda *a: g1.normalize(a), cold_copies(S), 5)
    # bucket_sum and bucket_reduce: the kernels' launches alone, beside
    # the wrappers' whole calls (the chunk tables, their syncs, the base
    # rows, the buffers)
    t_bsum, _ = k3_bucket_sum_ms(g1, A, segs, 5)
    w_bsum = events_ms(lambda *a: g1.bucket_sum(A, *a), [segs], 5)
    t_bred = k3_bucket_reduce_ms(g1, B, c_def, 5)
    w_bred = events_ms(lambda *a: g1.bucket_reduce(a, c_def), [B], 5)
    p_add = cuda_ms(lambda: g1.jacobian_add_plain(P, Q), 1)
    p_dbl = cuda_ms(lambda: g1.jacobian_double_plain(S), 1)
    p_smul = cuda_ms(lambda: g1.batch_scalar_mul_plain(sub, ks, 254), 1)
    set_m = int(sum(int(x).bit_count() for x in words_to_ints(ks)))
    finite = int((~fq.is_zero(S[2])).sum())
    entries = int((segs[2] - segs[1]).sum())
    nonempty = int(((segs[2] - segs[1]) > 0).sum())
    for form, t, plain_t, lanes, b in (
            ("add", t_add, p_add, n, k3_bound_ms("add", n, generic)),
            ("double", t_dbl, p_dbl, n, k3_bound_ms("double", n)),
            ("scalar_mul", t_smul_m, p_smul, m,
             k3_bound_ms("scalar_mul", m, bits=254, set_bits=set_m)),
            ("normalize", t_norm, p_norm, n,
             k3_bound_ms("normalize", n, finite)),
            ("bucket_sum", t_bsum, p_bsum, n,
             k3_bound_ms("bucket_sum", n, entries=entries,
                         segments=nonempty, n_seg=segs[1].numel())),
            ("bucket_reduce", t_bred, p_bred, n_win,
             k3_bound_ms("bucket_reduce", n_win, c=c_def))):
        forms[form] = {"ms": t, "plain_ms": plain_t, "lanes": lanes,
                       "bound_ms": b[0], "bound_by": b[1],
                       "max_abs_err": errs[form]}
        print(f"[g1] {form} at {lanes} lanes: {t:.4f} ms (CUDA events, "
              f"the kernel alone) (bound {b[0]:.4f} ms, {b[1]}; "
              f"{b[0] / t:.1%} of it), plain {plain_t:.2f} ms; first K3 "
              f"(PERF.md, PR 9): {FIRST_K3_MS.get(form)} ms", flush=True)
    forms["bucket_sum"].update(entries=entries, segments=nonempty,
                               levels=lk5["bucket_sum"], c=c_def,
                               wrapper_ms=w_bsum, plumbing_ms=w_bsum - t_bsum)
    forms["bucket_reduce"].update(c=c_def, wrapper_ms=w_bred)
    print(f"[g1] bucket_sum's whole call {w_bsum:.4f} ms (CUDA events): "
          f"{t_bsum:.4f} ms in its {lk5['bucket_sum']} level launches, "
          f"{w_bsum - t_bsum:.4f} ms of torch plumbing (the base rows, the "
          f"chunk tables and a host sync a level, the scatter); "
          f"bucket_reduce's whole call {w_bred:.4f} ms (its buffers and "
          f"the counter's memset around the {t_bred:.4f} ms launch)",
          flush=True)
    del Q, D, M, E, Aneg, hp

    # (b) the 2^20 KZG setup on the card: one scalar_mul and one normalize
    srs_dir = tempfile.mkdtemp(prefix="kzg_srs_")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    kzg = KZGSetup.generate(1 << KZG_LOG_N, device=dev, cache_dir=srs_dir)
    torch.cuda.synchronize()
    t_kzg = time.perf_counter() - t0
    setup_launches = {f: k for f, k in kernels.k3_launches().items() if k}
    check(setup_launches == {"scalar_mul": 1, "normalize": 1},
          f"the KZG setup launched K3 {setup_launches}")
    rng = random.Random(SEED)
    picks = list(range(64)) + sorted(rng.sample(range(64, 1 << KZG_LOG_N),
                                                64))
    got = g1.unpack_points(tuple(c[:, picks] for c in kzg.g1_powers_dev))
    check(got == [host.g1_mul(host.G1_GEN, pow(DEFAULT_TAU, i, R))
                  for i in picks], "a KZG power differs from [tau^i] G1")
    check(fq.unpack_ints(kzg.g1_powers_dev[2][:, picks]) == [1] * 128,
          "the KZG powers are not affine")
    tau_words = [pow(DEFAULT_TAU, i, R) for i in range(1 << KZG_LOG_N)]
    raw = b"".join(k.to_bytes(32, "little") for k in tau_words)
    tw = torch.from_numpy(np.frombuffer(raw, dtype="<u4").reshape(-1, 8).T
                          .copy().view(np.int32)).to(dev)
    kn = 1 << KZG_LOG_N
    gens = tuple(c.expand(-1, kn) for c in base)
    t_smul = events_ms(lambda *a: g1.batch_scalar_mul(a[:3], a[3], 254),
                       [(*gens, tw)], 3)
    set_n = sum(k.bit_count() for k in tau_words)
    b_smul = k3_bound_ms("scalar_mul", kn, bits=254, set_bits=set_n)
    forms["scalar_mul"].update(setup_ms=t_smul, setup_lanes=kn,
                               setup_bound_ms=b_smul[0])
    del tw, tau_words, raw
    print(f"[kzg] KZGSetup.generate(2^{KZG_LOG_N}, device=cuda) "
          f"{t_kzg:.3f}s (tau powers on the host, one K3 scalar_mul of "
          f"{t_smul:.2f} ms by CUDA events, bound {b_smul[0]:.2f} ms, "
          f"{b_smul[0] / t_smul:.1%} of it (first K3, PERF.md, PR 9: "
          f"{FIRST_K3_MS['scalar_mul_setup']} ms), one normalize, the cache "
          "written); 64 first and 64 seeded powers == [tau^i] G1, affine",
          flush=True)

    # (c) the window width: the whole MSM from device words at 2^9 ..
    # 2^22 lanes and c = 4 .. 16 (the bases 2^22 affine points of general
    # value), then the default width's commits: 2^20 from device words and
    # from Python ints, 2^22 with its peaks
    n22 = 1 << 22
    A22 = g1.normalize(g1.batch_scalar_mul(
        tuple(c.expand(-1, n22) for c in base), rand_words(2, n22), 64))
    w22 = rand_words(8, n22, top_bits=30)
    sweep = msm_width_sweep(g1, A22, w22, MSM_SWEEP_LOG_N)

    def commit_run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        return (out, t, torch.cuda.max_memory_allocated(dev) - before,
                {f: k for f, k in kernels.k3_launches().items() if k})
    dense = kzg.g1_powers_dev
    commit_run(lambda: g1.msm(dense, words, 254))
    _, t_dev, peak_dev, l_dev = commit_run(lambda: g1.msm(dense, words,
                                                          254))
    rng = random.Random(SEED + 1)
    full = [rng.randrange(R) for _ in range(1 << KZG_LOG_N)]
    hk = HyperKZG(kzg)
    hk.commit_ints(full[:1024])
    c_full, t_ints, peak_ints, l_ints = commit_run(
        lambda: hk.commit_ints(full))
    check(c_full is not None and host.g1_is_on_curve(c_full),
          "the full-width commitment is not a curve point")
    b20 = msm_bound_ms(n, 254, c_def)
    print(f"[kzg] one full-width 2^{KZG_LOG_N} commit at c = {c_def}: from "
          f"device words {t_dev * 1e3:.3f} ms (bound {b20[0]:.3f} ms; "
          f"K3 {l_dev}), peak {peak_dev / 2**30:.3f} GiB beyond the "
          f"bases; from Python ints (HyperKZG.commit_ints: the words, "
          f"the upload, the MSM, the unpack) {t_ints:.3f}s, peak "
          f"{peak_ints / 2**30:.3f} GiB (the first K3's Pippenger: 2.464 s, "
          "0.595 GiB)",
          flush=True)
    del full, words, segs, B
    base_bytes = 3 * A22[0].numel() * 4
    c22 = g1.window_bits(n22)
    commit_run(lambda: g1.msm(A22, w22, 254))
    _, t22, peak22, l22 = commit_run(lambda: g1.msm(A22, w22, 254))
    b22 = msm_bound_ms(n22, 254, c22)
    # one window a batch, as at 2^26 (_MSM_ENTRIES = 2^25 < 2^26 lanes):
    # every buffer then scales with N, so 16 x this peak is 2^26's
    batch_entries = g1._MSM_ENTRIES
    g1._MSM_ENTRIES = n22
    try:
        _, t22_1, peak22_1, _ = commit_run(lambda: g1.msm(A22, w22, 254))
    finally:
        g1._MSM_ENTRIES = batch_entries
    print(f"[kzg] one 2^22 commit at c = {c22} from device words: "
          f"{t22 * 1e3:.3f} ms (bound {b22[0]:.3f} ms; K3 {l22}); peak "
          f"{peak22 / 2**30:.3f} GiB beyond the bases ({base_bytes / 2**30:.3f}"
          f" GiB); one window a batch (2^26's batching) {t22_1 * 1e3:.3f} "
          f"ms, peak {peak22_1 / 2**30:.3f} GiB beyond them (host clock, "
          f"synchronized); reckoned, not measured: 16 x that peak at 2^26, "
          f"~{peak22_1 * 16 / 2**30:.2f} GiB beyond "
          f"{base_bytes * 16 / 2**30:.1f} GiB of bases", flush=True)
    del A22, w22

    # (d) the KZG prove of the sha2-chain at chain=1 (2^20 SRS) and verify
    kt = sha2_chain_trace(1)
    check(required_num_vars(kt.padded_length, 0, 0) == KZG_LOG_N,
          f"the chain=1 trace ({kt.padded_length}) does not fit 2^20")
    dense_c = []
    commit = scheme_mod.HyperKZGScheme.commit

    def record(self, name, coeffs, bits=254):
        out = commit(self, name, coeffs, bits)
        dense_c.append((name, list(coeffs), out))
        return out
    scheme_mod.HyperKZGScheme.commit = record
    # the prove's MSMs by lane count (ceil log2), the sizes the window
    # width sweep covers
    msm = g1.msm
    msm_sizes = {}

    def sized(P, scalars, bits):
        L = (scalars.shape[-1] - 1).bit_length()
        msm_sizes[L] = msm_sizes.get(L, 0) + 1
        return msm(P, scalars, bits)
    g1.msm = sized
    kprof = profiling.PROFILER = profiling.Profiler()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    try:
        t0 = time.perf_counter()
        kproof, ks_s, _, kl = timed_stages(
            lambda: prove(kt, setup=kzg, device=dev))
        t_kprove = time.perf_counter() - t0
    finally:
        k3 = kernels.k3_launches()
        k1 = sum(kernels.k1_launches().values())
        k2 = kernels.product_round.launches
        scheme_mod.HyperKZGScheme.commit = commit
        g1.msm = msm
        profiling.PROFILER = profiling.Profiler(enabled=False)
    kpeak = torch.cuda.max_memory_allocated(dev)
    path_forms = ("add", "scalar_mul", "bucket_sum", "bucket_reduce")
    check(all(k3[f] for f in path_forms) and k1 and k2,
          f"the KZG prove launched K1 {k1}, K2 {k2}, K3 {k3}")
    check(type(kproof.opening_proofs["joint"]).__name__ == "HyperKZGProof",
          "the KZG proof carries no HyperKZG opening")
    t0 = time.perf_counter()
    check(verify(kproof, PublicIO.from_trace(kt), setup=kzg) is True,
          "verify rejected the KZG proof")
    t_kverify = time.perf_counter() - t0
    name, coeffs, com = dense_c[0]
    hp = g1.unpack_points(tuple(c[:, :len(coeffs)]
                                for c in kzg.g1_powers_dev))
    check(com == host.g1_msm_pippenger(hp, coeffs),
          f"the dense commitment {name} differs from the host MSM")
    spans = {k: kprof.total(k) for k in ("kzg.commit", "kzg.open.folds",
                                         "kzg.open.evals",
                                         "kzg.open.quotients")}
    by_stage = {k: {f: c for f, c in v["k3"].items() if c}
                for k, v in kl.items() if any(v["k3"].values())}
    print(f"[kzg] prove(sha2-chain chain=1: {kt.length} cycles, padded "
          f"{kt.padded_length}; setup 2^{KZG_LOG_N}) {t_kprove:.3f}s: "
          + ", ".join(f"{k} {v:.3f}s" for k, v in ks_s.items())
          + f"; peak allocated {kpeak / 2**30:.3f} GiB; K1 {k1}, K2 {k2}, "
          f"K3 {k3} ({sum(k3.values())}); verify(setup) {t_kverify:.3f}s; "
          f"dense commitment {name} ({len(coeffs)} coefficients) == the "
          "host MSM", flush=True)
    print(f"[kzg] the prove's MSMs by lane count (ceil log2: calls): "
          f"{dict(sorted(msm_sizes.items()))}", flush=True)
    print(f"[kzg] K3 launches by stage: {by_stage}; spans (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()), flush=True)
    for f in kernels.K3_FORMS:
        forms[f]["launches"] = k3[f]
    del kproof, hp

    # (e) card == CPU with a 2^13 KZG setup on the PCS guest
    kzg13 = KZGSetup.generate(1 << 13, device=dev, cache_dir=srs_dir)
    n_pcs = card_vs_cpu(pcs_guest, "the PCS guest with a 2^13 KZG setup",
                        setup=kzg13)
    print(f"[kzg] card == CPU: the PCS guest ({pcs_guest.length} cycles) "
          f"with a 2^13 KZG setup: identical proof bytes ({n_pcs} B) and FS "
          "tape; verified", flush=True)

    # (f) Dory's one-hot tier 1 at the main path's size: the K3 route
    # against the native route (the route argument).  Gamma1's pack to the
    # card timed alone (the setup keeps the main path's copy)
    t0 = time.perf_counter()
    g1.pack_points(dory_setup.gamma1, dev)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    dory = Dory(dory_setup, dev)
    dory_setup.gamma1_on(dev)
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dev_rows = dory.onehot_rows(onehot_positions)
    t_scan = time.perf_counter() - t0
    speak = torch.cuda.max_memory_allocated(dev)
    s_launch = {f: k for f, k in kernels.k3_launches().items() if k}
    native = Dory(dory_setup, dev, _k3=False)
    native._gamma1_buf()
    t0 = time.perf_counter()
    nat_rows = native.onehot_rows(onehot_positions)
    t_native = time.perf_counter() - t0
    lanes = sum(len(p) for p in onehot_positions)
    check(dev_rows == nat_rows,
          "the device one-hot tier differs from the native segment sums")
    # its bucket_sum alone at this shape (the main path's largest K3
    # call, K3's headline): against the plain version, and its level
    # launches timed alone beside the bound
    gam = dory_setup.gamma1_on(dev)
    cols_np, off_np, _ = dory.onehot_segments(onehot_positions)
    oh_lanes = torch.from_numpy(cols_np.astype(np.int32)).to(dev)
    oh_off = torch.from_numpy(off_np.astype(np.int64)).to(dev)
    OB = g1.bucket_sum(gam, oh_lanes, oh_off)
    t0 = time.perf_counter()
    oh_err = max_err(OB, g1.bucket_sum_plain(gam, oh_lanes, oh_off))
    p_oh = (time.perf_counter() - t0) * 1e3
    check(oh_err == 0, "K3 bucket_sum differs from its plain version at "
          f"the one-hot tier's shape: {oh_err}")
    err = max(err, oh_err)
    n_seg = len(off_np) - 1
    t_oh, oh_levels = k3_bucket_sum_ms(
        g1, gam, (oh_lanes, oh_off[:-1], oh_off[1:]), 5)
    b_oh = k3_bound_ms("bucket_sum", gam[0].shape[1], entries=len(cols_np),
                       segments=n_seg, n_seg=n_seg)
    print(f"[g1] bucket_sum at the one-hot tier's shape ({len(cols_np)} "
          f"entries, {n_seg} segments over 2^{dory_setup.sigma} bases, "
          f"{oh_levels} levels): {t_oh:.4f} ms (CUDA events, the level "
          f"launches alone) (bound {b_oh[0]:.4f} ms, {b_oh[1]}; "
          f"{b_oh[0] / t_oh:.1%} of it), plain {p_oh:.2f} ms; == the plain "
          "version bit for bit", flush=True)
    del OB
    n_rows = sum(r is not None for rows in dev_rows for r in rows)
    print(f"[g1] Dory's device one-hot tier at 2^18: "
          f"{len(onehot_positions)} matrices, {lanes} lanes, {n_rows} row "
          f"sums == native_pairing.g1_segment_sums point for point; device "
          f"tier {t_scan:.3f}s (bucket_sum over the rows: K3 {s_launch}, "
          f"the unpack; peak allocated {speak / 2**30:.3f} GiB; the first "
          f"K3's segmented scan: 1.250 s with the pack), native "
          f"{t_native:.3f}s (Gamma1's encoding made before); Gamma1's pack "
          f"to the card ({len(dory_setup.gamma1)} points) {t_pack:.3f}s",
          flush=True)
    print(f"[g1] phase 8b {time.perf_counter() - t_phase:.1f}s", flush=True)
    entry = {
        "name": "g1", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/g1.cu",
        "replaces": "jolt_tpu/curve/g1.py (jnp)",
        "kzg_launches": sum(k3.values()), "max_abs_err": err,
        "ms": t_oh, "plain_ms": p_oh,
        "bound_ms": b_oh[0], "bound_by": b_oh[1],
        "library_ms": None, "form": "bucket_sum",
        "shape": [[8, gam[0].shape[1]]] * 3 + [[len(cols_np)], [n_seg + 1]],
        "levels": oh_levels, "forms": forms,
        "kzg_launches_by_form": k3, "kzg_launches_by_stage": by_stage,
        "setup_launches": setup_launches, "msm_c_sweep": sweep,
        "kzg_setup_s": t_kzg, "kzg_prove_s": t_kprove,
        "kzg_stage_s": ks_s, "kzg_spans_s": spans,
        "kzg_peak_gib": kpeak / 2**30,
        "commit_2_20_device_words_ms": t_dev * 1e3,
        "commit_2_20_python_ints_s": t_ints,
        "commit_2_20_peak_gib": peak_ints / 2**30,
        "commit_2_22_ms": t22 * 1e3, "commit_2_22_peak_gib": peak22 / 2**30,
        "onehot_pack_s": t_pack, "kzg_msm_lanes": msm_sizes,
        "commit_2_22_one_window_ms": t22_1 * 1e3,
        "commit_2_22_one_window_peak_gib": peak22_1 / 2**30,
        "msm_bound_ms_2_20": b20[0], "msm_bound_ms_2_22": b22[0],
        "onehot_device_s": t_scan, "onehot_native_s": t_native}
    return entry


@contextlib.contextmanager
def stage1_peaks(prover_mod, out):
    """Inside: the card's peak allocated memory before stage 1
    (out["before_s1"]) and over stage 1 alone (out["s1"]: reset as its
    uni-skip round starts, read at the stage's mark).  The caller resets
    the peak before and reads it after; the whole run's peak is the larger
    of out["before_s1"] and that reading."""
    real_uniskip, real_mark = prover_mod.prove_uniskip, \
        prover_mod._StageTimer.mark

    def uniskip(*args, **kwargs):
        out["before_s1"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return real_uniskip(*args, **kwargs)

    def mark(self, label):
        if label == "stage1-spartan":
            out["s1"] = torch.cuda.max_memory_allocated()
        return real_mark(self, label)
    prover_mod.prove_uniskip, prover_mod._StageTimer.mark = uniskip, mark
    try:
        yield out
    finally:
        prover_mod.prove_uniskip = real_uniskip
        prover_mod._StageTimer.mark = real_mark


@contextlib.contextmanager
def watch_loop_syncs(fused, syncs):
    """Inside: each device-tier stage's loop and finals
    (`fused._device_rounds`) under the sync debug mode "warn", the
    file:line of every synchronizing CUDA call there appended to
    `syncs`."""
    real = fused._device_rounds

    def rounds(*args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return real(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.extend(f"{w.filename}:{w.lineno}" for w in caught
                             if "called a synchronizing CUDA operation"
                             in str(w.message))
    fused._device_rounds = rounds
    try:
        yield syncs
    finally:
        fused._device_rounds = real


def watched_prove(fn, kernels, fused, prover_mod, so):
    """fn() (a `prove`) with the launch counts and fetches set to 0 just
    before and read just after, every device-tier stage's loop and finals
    under the sync debug mode (each synchronizing call's file:line kept),
    stage 1's tier (`stream_chunk`'s answers), and the card's peaks over
    the run and over stage 1 (`stage1_peaks`)."""
    from jolt_tpu_torch.workload import timed_stages
    out = {"syncs": [], "chunks": []}
    real_chunk = so.stream_chunk

    def chunk(*args):
        out["chunks"].append(real_chunk(*args))
        return out["chunks"][-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    fused.fetches = 0
    so.stream_chunk = chunk
    peaks = {}
    try:
        with stage1_peaks(prover_mod, peaks), \
                watch_loop_syncs(fused, out["syncs"]):
            t0 = time.perf_counter()
            out["proof"], out["stage_s"], _, out["launches"] = \
                timed_stages(fn)
            out["s"] = time.perf_counter() - t0
    finally:
        so.stream_chunk = real_chunk
    out["fetches"], out["k4"] = fused.fetches, kernels.k4_launches()
    out["k1"] = sum(kernels.k1_launches().values())
    out["peak"] = max(peaks["before_s1"], torch.cuda.max_memory_allocated())
    out["s1_peak"] = peaks["s1"]
    return out


def k1_by_stage(launches):
    return {k: sum(v["k1"].values()) for k, v in launches.items()}


def a19_phase(traces, dev, kernels, fused):
    """Phase 7b: the alternative tiers on each (name, trace), card against
    the host engine and the CPU (tests/test_torch_cuda.py's builders); the
    dense Twist provers on fib only."""
    from test_torch_cuda import (dense_stages, onehot_stage, run_stage,
                                 test_naive_expr_equals_dense_opening_on_card)
    out = {}
    for name, trace in traces:
        syncs = []
        f0 = fused.fetches
        with watch_loop_syncs(fused, syncs):
            t0 = time.perf_counter()
            on_tier, k4 = run_stage(onehot_stage(trace, dev), "device")
            t_tier = time.perf_counter() - t0
        fetches = fused.fetches - f0
        t0 = time.perf_counter()
        on_host, k4_host = run_stage(onehot_stage(trace, dev), "host")
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu, _ = run_stage(onehot_stage(trace, "cpu"), "host")
        t_cpu = time.perf_counter() - t0
        insts = onehot_stage(trace, "cpu")
        rounds_ = max(i.num_rounds for i in insts)
        check(on_tier == on_host == on_cpu, f"{name}: the one-hot relations "
              "differ between the device tier, the host engine and the CPU")
        check(k4 == rounds_ and k4_host == 0 and fetches == 1,
              f"{name}: K4 {k4} (want {rounds_}), host engine K4 {k4_host}, "
              f"fetches {fetches}")
        check(not syncs, f"{name}: the one-hot stage synchronized at "
              f"{collections.Counter(syncs)}")
        print(f"[a19] {name} (T = {trace.padded_length}): Booleanity, "
              f"HammingWeight, SparseOneHotOpening x {len(insts) // 3} "
              f"streams (K = {[i.K for i in insts[::3]]}), {rounds_} rounds: "
              f"device tier {t_tier:.3f}s (K4 {k4}, one fetch, no sync) == "
              f"host engine {t_host:.3f}s == CPU {t_cpu:.3f}s", flush=True)
        out[name] = {"onehot_rounds": rounds_, "k4": k4,
                     "device_tier_s": t_tier, "host_engine_s": t_host,
                     "cpu_s": t_cpu}
        if name != "fib":
            continue
        for which, card_st, cpu_st in zip(("registers", "ram"),
                                          dense_stages(trace, dev),
                                          dense_stages(trace, "cpu")):
            t0 = time.perf_counter()
            got = run_stage(card_st, "host")
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = run_stage(cpu_st, "host")
            check(got == want, f"{name}: the dense {which} provers differ "
                  "between cuda and cpu")
            print(f"[a19] {name}: dense {which} provers ({len(card_st)}), "
                  f"card {t_card:.3f}s == CPU {time.perf_counter() - t0:.3f}s",
                  flush=True)
    test_naive_expr_equals_dense_opening_on_card(dev)
    print("[a19] the naive interpreter == a DenseOpening on the card "
          "(round polynomials)", flush=True)
    return out


def mesh_phase(tr, setup, proof, stage_launches, t_prove, peak, dev):
    """Phase 6d: the cycle mesh (`jolt_tpu_torch/parallel/mesh.py`).

    (a) D = 1 over NCCL in this process: the main run's trace and setup
    under `use_mesh(cycle_mesh(1))` -- bytes and FS tape == the main
    run's, K4 0 and every stage on the host engine, K1 / K2 per stage,
    seconds and peak; then the D = 1 proof of the chain=1 trace under
    `CommDebugMode`, the collectives by kind and stage.
    (b) D = 2, both ranks on this card, over gloo (NCCL takes one card a
    rank): first which of DTensor's collectives gloo carries on CUDA
    tensors, each on a pair of ranks of its own; where it carries those
    the prove issues (`spawn.REQUIRED`), each rank's chain=1 proof ==
    D = 1's, with K1 launched on both ranks.  The one refusal accepted is
    the one seen (ROADMAP C4: the all-gather ending a rank with SIGSEGV,
    the all-reduce right): the `[mesh] (b) REFUSED` line names it and no
    D = 2 proof runs here; any other probe result fails the run."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from jolt_tpu_torch import prove
    from jolt_tpu_torch.field import kernels, ops
    from jolt_tpu_torch.parallel import cycle_mesh, use_mesh
    from jolt_tpu_torch.parallel.spawn import (REQUIRED, comm_by_stage,
                                               probe_collectives, probe_ranks,
                                               prove_rank, run_ranks)
    from jolt_tpu_torch.proof_io import serialize_proof
    from jolt_tpu_torch.prover import prover as prover_mod
    from jolt_tpu_torch.sumcheck import fused
    from jolt_tpu_torch.workload import sha2_chain_trace, timed_stages

    main_bytes = serialize_proof(proof)
    tmp = tempfile.TemporaryDirectory(prefix="jolt_mesh_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp.name, "store"), 1), rank=0, world_size=1)
    try:
        mesh = cycle_mesh(1)
        probe1 = probe_collectives(mesh)
        check(all(probe1[c] == "ok" for c in REQUIRED),
              f"NCCL at D = 1 refused a collective: {probe1}")
        tiers = []
        real_tier = fused.device_tier

        def watched(instances):
            tiers.append(real_tier(instances))
            return tiers[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        fused.device_tier, fused.fetches = watched, 0
        try:
            t0 = time.perf_counter()
            with use_mesh(mesh):
                p1, stage_s1, _, launches1 = timed_stages(
                    lambda: prove(tr, setup=setup, device="cuda"))
            t1 = time.perf_counter() - t0
        finally:
            fused.device_tier = real_tier
        peak1 = torch.cuda.max_memory_allocated(dev)
        k4, fetches = kernels.k4_launches(), fused.fetches
        check(serialize_proof(p1) == main_bytes
              and p1.fs_tape == proof.fs_tape,
              "the D = 1 mesh proof differs from the main run's")
        check(k4 == 0 and fetches == 0 and tiers and not any(tiers),
              f"under the mesh: K4 {k4}, {fetches} fetches, device tier by "
              f"stage {tiers} (want 0, 0, all host engine)")
        k1_1 = {k: sum(v["k1"].values()) for k, v in launches1.items()}
        k2_1 = {k: v["k2"] for k, v in launches1.items()}
        k3_1 = {k: sum(v["k3"].values()) for k, v in launches1.items()}
        check(sum(k1_1.values()) > 0 and sum(k2_1.values()) > 0,
              f"K1 / K2 did not launch under the mesh: {k1_1} {k2_1}")
        del p1
        # the chain=1 trace at D = 1, (b)'s reference, under CommDebugMode:
        # its collectives by kind and stage (a one-rank mesh issues none)
        tr1 = sha2_chain_trace(1)
        comm = CommDebugMode()
        comm_stages = comm_by_stage(comm)
        try:
            t0 = time.perf_counter()
            with comm, use_mesh(mesh):
                ref1 = prove(tr1, device="cuda")
            t2 = time.perf_counter() - t0
        finally:
            prover_mod.stage_hooks.pop()
        ref1_bytes, ref1_tape = serialize_proof(ref1), ref1.fs_tape
        del ref1
    finally:
        ops._replicated.cache_clear()
        dist.destroy_process_group()
        tmp.cleanup()
    print(f"[mesh] (a) D = 1 over NCCL, the main run's trace and setup: "
          f"bytes and FS tape == the main run's; K4 0, {len(tiers)} stages "
          f"all on the host engine, 0 fetches; prove {t1:.3f}s (main run "
          f"{t_prove:.3f}s), peak {peak1 / 2**30:.3f} GiB (main "
          f"{peak / 2**30:.3f}); K1 {sum(k1_1.values())}, K2 "
          f"{sum(k2_1.values())}, K3 {sum(k3_1.values())}; NCCL carries "
          f"{probe1}", flush=True)
    for label in stage_s1:
        print(f"[mesh] (a) {label}: {stage_s1[label]:.4f}s, K1 "
              f"{k1_1[label]}, K2 {k2_1[label]}, K3 {k3_1[label]}",
              flush=True)
    print(f"[mesh] (a) chain=1 ({tr1.length} cycles, padded "
          f"{tr1.padded_length}) at D = 1 under CommDebugMode: {t2:.3f}s, "
          f"collectives by stage {comm_stages}", flush=True)
    # (b) two ranks on this card over gloo, chain=1 at setup=None: first
    # each collective on a pair of ranks of its own (a backend that kills
    # its process still names the collective), then the proof
    t0 = time.perf_counter()
    probe2 = probe_ranks(2, "gloo", "cuda")
    print(f"[mesh] (b) gloo, two ranks on this card, DTensor's collectives "
          f"on CUDA tensors: {probe2}", flush=True)
    refused = [c for c in REQUIRED if probe2[c] != "ok"]
    outs = []
    if refused:
        # the finding (PERF.md, ROADMAP C4): gloo's funcol all-gather of
        # CUDA tensors ends its rank with SIGSEGV, and NCCL refuses a second
        # rank on a card; the port does not stage a collective through the
        # host.  That one refusal is accepted; anything else fails the run
        # (a wrong result, a failed all-reduce, another error)
        gather = probe2["all_gather_into_tensor"]
        check(refused == ["all_gather_into_tensor"]
              and probe2["all_reduce"] == "ok"
              and gather.startswith("a rank died") and "SIGSEGV" in gather,
              f"gloo on CUDA tensors: {probe2} (the one refusal accepted is "
              "all_gather_into_tensor ending a rank with SIGSEGV, with "
              "all_reduce ok)")
        print(f"[mesh] (b) REFUSED: gloo does not carry {refused} on CUDA "
              f"tensors (torch {torch.__version__}); the D = 2 proof on "
              "this card is not run (D = 2-8 are held on the CPU, "
              "tests/test_torch_mesh*.py)", flush=True)
    else:
        outs = run_ranks(prove_rank, 2, tr1, None, "cuda", None, True,
                         backend="gloo", threads=None)
    for rank, o in enumerate(outs):
        used = {c for st in o["comm"].values() for c in st}
        check(used <= set(REQUIRED), f"rank {rank}'s prove issued "
              f"{sorted(used)} (the probe covers {REQUIRED})")
        check(o["bytes"] == ref1_bytes and o["fs_tape"] == ref1_tape,
              f"rank {rank}'s D = 2 proof differs from D = 1's")
        check(sum(o["k1"].values()) > 0 and o["k4"] == 0
              and o["fetches"] == 0,
              f"rank {rank}: K1 {o['k1']}, K4 {o['k4']}, fetches "
              f"{o['fetches']}")
        print(f"[mesh] (b) rank {rank}: chain=1 ({tr1.length} cycles, padded "
              f"{tr1.padded_length}) bytes and FS tape == D = 1's; prove "
              f"{o['seconds']:.3f}s under CommDebugMode; K1 "
              f"{sum(o['k1'].values())} {o['k1']}, K2 {o['k2']}, K4 0",
              flush=True)
        for label, c in o["comm"].items():
            print(f"[mesh] (b) rank {rank} {label}: collectives {c}",
                  flush=True)
    t_b = time.perf_counter() - t0
    print(f"[mesh] (b) {t_b:.1f}s", flush=True)
    return {"d1": {"prove_s": t1, "main_prove_s": t_prove,
                   "chain1_counted_prove_s": t2, "peak_bytes": peak1,
                   "k1_by_stage": k1_1, "k2_by_stage": k2_1,
                   "k3_by_stage": k3_1, "k4": 0,
                   "stage_s": stage_s1, "collectives_by_stage": comm_stages,
                   "probe": probe1},
            "d2_gloo": {"probe": probe2, "refused": refused,
                        "ranks": [{"prove_s": o["seconds"], "k1": o["k1"],
                                   "k2": o["k2"],
                                   "collectives_by_stage": o["comm"]}
                                  for o in outs]},
            "d2_s": t_b}


def cli_phase(prove, serialize_proof, trace_program, MemoryLayout):
    """Phase 7c: the CLI's prove (default device) and verify in
    subprocesses; the proof file's bytes == `prove` in this process."""
    guest, inputs = "examples/fibonacci.s", "0a00000000000000"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fib.proof")
        cmd = [sys.executable, "-m", "jolt_tpu_torch.cli"]
        t0 = time.perf_counter()
        p = subprocess.run(cmd + ["prove", guest, "--input", inputs, "-o",
                                  path], cwd=ROOT, capture_output=True,
                           text=True, timeout=900)
        t_prove = time.perf_counter() - t0
        check(p.returncode == 0, f"cli prove failed: {p.stderr[-2000:]}")
        v = subprocess.run(cmd + ["verify", guest, path, "--input", inputs],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=900)
        accept = [ln for ln in v.stdout.splitlines() if "verified in" in ln]
        check(v.returncode == 0 and accept and accept[0].endswith(": True"),
              f"cli verify: {v.stdout[-2000:]} {v.stderr[-2000:]}")
        blob = open(path, "rb").read()
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    tr = trace_program((ROOT / guest).read_text(),
                       inputs=bytes.fromhex(inputs), layout=layout)
    proof = prove(tr, device="cuda")
    statement = {"trace_length": tr.length,
                 "padded_length": tr.padded_length,
                 "outputs": bytes(tr.device.outputs),
                 "panic": tr.device.panic}
    check(blob == serialize_proof(proof, statement),
          "the CLI's proof file differs from prove(trace, device='cuda')")
    print(f"[cli] python -m jolt_tpu_torch.cli prove {guest} (default "
          f"device, the card): {t_prove:.2f}s with the process's start; "
          f"[{p.stdout.strip().splitlines()[0]}]; cli verify: "
          f"[{accept[0]}]; proof file ({len(blob)} B) == prove(trace, "
          "device='cuda')", flush=True)
    return {"cli_prove_s": t_prove, "proof_bytes": len(blob)}


def main():
    ap = argparse.ArgumentParser(description="Smoke run of the torch port "
                                 "on one NVIDIA GPU (see the module "
                                 "docstring).")
    ap.add_argument("--old-k4", type=pathlib.Path, default=None,
                    help="an unpacked tree of commit c3a2d92, whose K4 "
                    "phase 4b times beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import PublicIO, prove, verify
    from jolt_tpu_torch.curve import native_pairing
    from jolt_tpu_torch.field import kernels, ops
    from jolt_tpu_torch.kernels import JoltBackend, set_backend
    from jolt_tpu_torch.pcs import scheme as scheme_mod
    from jolt_tpu_torch.pcs.dory import SRS_CACHE_DIR, DorySetup
    from jolt_tpu_torch.prover.prover import required_num_vars
    from jolt_tpu_torch.poly import eq
    from jolt_tpu_torch.proof_io import serialize_proof
    from jolt_tpu_torch.prover.prover import (BC_RA_SOURCES, RAM_RA_SOURCES,
                                              committed_poly_names)
    from jolt_tpu_torch.relations.grouped_onehot import GroupedOneHot
    from jolt_tpu_torch.relations.program_image import image_words
    from jolt_tpu_torch.relations.ra_virtual import (RaVirtual, block_widths,
                                                     chunk_streams, d_chunks)
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.sumcheck import fused
    from jolt_tpu_torch.sumcheck.engine import (BatchedSumcheck,
                                                OpeningAccumulator)
    from jolt_tpu_torch.sumcheck.product import (ProductSumcheck,
                                                 VerifierProductSumcheck,
                                                 round_step)
    from jolt_tpu_torch.tracer import trace_program
    from jolt_tpu_torch.transcript import Blake2bTranscript
    from jolt_tpu_torch.transcript import device as dt
    from jolt_tpu_torch.utils import profiling
    from jolt_tpu_torch.verifier import verifier as verifier_mod
    from jolt_tpu_torch.prover import prover as prover_mod
    from jolt_tpu_torch.relations import spartan_outer as so
    from jolt_tpu_torch.workload import (SHA2_CHAIN, SHA2_CHAIN_2_20,
                                         SHA2_CHAIN_2_20_CYCLES, card_line,
                                         host_line, sha2_chain_trace,
                                         stage_device_s, timed_stages)

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ---- 1. the card ----------------------------------------------------
    card = card_line()
    print(f"[card] {card}  torch {torch.__version__} cuda {torch.version.cuda}"
          f"  {torch.cuda.get_device_name(0)}", flush=True)
    print(f"[host] {host_line()}", flush=True)
    check(not native_pairing.python_tier(),
          "JOLT_TPU_NO_NATIVE_PAIRING is set: Dory would run its Python tier")

    # ---- 2. build K1, K2 and the pairing library; the Dory setup --------
    print(f"[phase] 2 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    pairing_build = {}

    def build_pairing():
        try:
            pairing_build["path"] = native_pairing.build(force=True)
        except BaseException as e:           # re-raised after the join
            pairing_build["error"] = e
        pairing_build["s"] = time.perf_counter() - t0
    builder = threading.Thread(target=build_pairing)
    builder.start()
    # K4's stamped build (experiments/k4_parts.cu) and, with --old-k4, the
    # one-warp K4 from its tree, beside the others
    sys.path.insert(0, str(ROOT / "experiments"))
    import k4_parts as k4p
    k4_builds = {}

    def build_k4_extra():
        try:
            k4_builds["stamped"] = k4p.build(
                ROOT / "jolt_tpu_torch" / "csrc" / "transcript.cu", old=False)
            if args.old_k4 is not None:
                k4_builds["old"] = k4p.build(
                    args.old_k4 / "jolt_tpu_torch" / "csrc" / "transcript.cu",
                    old=True, kernel_only=True)
        except BaseException as e:           # re-raised after the join
            k4_builds["error"] = e
    k4_builder = threading.Thread(target=build_k4_extra)
    k4_builder.start()
    reports = kernels.build()
    t_nvcc = time.perf_counter() - t0
    builder.join()
    k4_builder.join()
    if "error" in pairing_build:
        raise pairing_build["error"]
    if "error" in k4_builds:
        raise k4_builds["error"]
    check(native_pairing.available(), "the pairing library did not load")
    print(f"[build] K1, K2, K3 and K4 built in {t_nvcc:.2f}s; the pairing "
          f"library ({pairing_build['path']}) in {pairing_build['s']:.2f}s, "
          "all at once", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    k1_spills = spill_bytes(reports["K1"])
    k2_spills = spill_bytes(reports["K2"])
    k3_spills = spill_bytes(reports["K3"])
    k3_stack = stack_bytes(reports["K3"])
    k4_spills = spill_bytes(reports["K4"])
    k4_stack = stack_bytes(reports["K4"])
    print(f"[build] spill bytes (stores + loads, all kernels): K1 "
          f"{k1_spills}, K2 {k2_spills}, K3 {k3_spills}, K4 {k4_spills}; "
          f"K3's largest stack frame {k3_stack} bytes, K4's "
          f"{k4_stack}", flush=True)
    if "old" in k4_builds:
        old_report = k4_builds["old"][1]
        print(f"[build] one-warp K4 (from {args.old_k4}): spill bytes "
              f"{spill_bytes(old_report)}, stack frame "
              f"{stack_bytes(old_report)} bytes; "
              + " ".join(ln.strip() for ln in old_report.splitlines()
                         if "registers" in ln), flush=True)
    check(k3_spills == 0 and k3_stack == 0,
          f"K3 spills {k3_spills} bytes or has a {k3_stack}-byte stack frame")
    check(k4_spills == 0 and k4_stack == 0,
          f"K4 spills {k4_spills} bytes or has a {k4_stack}-byte stack frame")
    # the main path's setup: 2^26 = 256 x 2^18, the largest committed
    # polynomial of the 2^18 trace
    t0 = time.perf_counter()
    cached = (pathlib.Path(SRS_CACHE_DIR) / "dory_torch_ate_10_16.pkl"
              ).exists()
    setup = DorySetup.generate(required_num_vars(1 << 18, 0, 0))
    t_setup = time.perf_counter() - t0
    check((setup.nu, setup.sigma) == (10, 16), "setup shape")
    print(f"[setup] Dory nu={setup.nu} sigma={setup.sigma}: {t_setup:.2f}s "
          f"({'loaded from the cache' if cached else 'generated'})",
          flush=True)

    # ---- 3. K1 vs plain in every form: 2^20, edge values, Python ints ----
    print(f"[phase] 3 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    P = kernels.P
    edge = [0, 1, P - 1]

    def draw(shape):
        return rand_field(shape, gen, dev)

    def draw_int():
        bits = torch.randint(0, 1 << 62, (5,), generator=gen,
                             device=dev).tolist()
        return sum(v << (62 * i) for i, v in enumerate(bits)) % P

    def draw_sums(shape):
        return rand_sums(shape, gen, dev)

    def draw_edge(shape):
        pick = torch.randint(0, 3, (math.prod(shape[1:]),), generator=gen,
                             device=dev).tolist()
        return ints_to_words([edge[v] for v in pick], dev).reshape(shape)

    def draw_edge_int():
        return edge[int(torch.randint(0, 3, (1,), generator=gen,
                                      device=dev))]

    def draw_edge_sums(shape):
        return kernels.u64_words(draw_edge(tuple(shape) + (64,))).sum(-1)

    n = 1 << 20
    # each form at 2^20 outputs, in the layouts of the main path
    k1_cases = {
        "mul": ((8, n), (8, n)), "add": ((8, n), (8, n)),
        "sub": ((8, n), "int"), "bind": ((8, n), "high", "int"),
        "evals": ((8, n), 3, "high"), "reduce": ((8, n), (8, 1)),
    }
    k1_err = {form: 0 for form in kernels.FORMS}
    k1_n20 = {}
    for form, key in k1_cases.items():
        args = k1_args(form, key, draw, draw_int, draw_sums)
        k1_err[form] = compare_k1(kernels, form, args, "at N = 2^20")
        k1_n20[form] = t = time_k1(kernels, form, args, key)
        print(k1_line(form, key, t), flush=True)
        del args
    # the shapes the one-column kernel was timed at (a product by a scalar
    # at 2^17 and 2^18 columns, a bind of 2^17 outputs) and their neighbours
    # up to 2^19
    k1_ref = {}
    for form, key in (("mul", ((8, 1 << 17), "int")),
                      ("mul", ((8, 1 << 18), "int")),
                      ("mul", ((8, 1 << 19), "int")),
                      ("bind", ((8, 1 << 17), "high", "int")),
                      ("bind", ((8, 1 << 18), "high", "int")),
                      ("bind", ((8, 1 << 17), "low", "int")),
                      ("bind", ((8, 1 << 18), "low", "int")),
                      ("bind", ((8, 1 << 19), "low", "int"))):
        args = k1_args(form, key, draw, draw_int, draw_sums)
        k1_err[form] = max(k1_err[form], compare_k1(kernels, form, args,
                                                    f"at {key}"))
        k1_ref[f"{form} {key}"] = t = time_k1(kernels, form, args, key)
        print(k1_line(form, key, t), flush=True)
    # the layouts at 2^20 not timed above: bind of pairs with a device r,
    # evals of split pairs, reduce without a scale
    for form, key in (("bind", ((8, n), "low", (8, 1))),
                      ("evals", ((8, n), 2, "split")),
                      ("reduce", ((8, n), None)),
                      ("mul", ((8, 4, 1), (8, 4, n // 4)))):
        args = k1_args(form, key, draw, draw_int, draw_sums)
        k1_err[form] = max(k1_err[form], compare_k1(kernels, form, args,
                                                    f"at {key}"))
    # 0, 1 and r-1 in every operand; a 512-element sample vs Python ints
    small = {
        "mul": [((8, 1024), (8, 1024)), ((8, 2, 512), "int")],
        "add": [((8, 1024), (8, 1024)), ((8, 1024), (8, 1))],
        "sub": [((8, 1024), (8, 1024)), ("int", (8, 1024))],
        "bind": [((8, 1024), "high", "int"), ((8, 1024), "low", (8, 1)),
                 ((8, 3, 512), "split", "int")],
        "evals": [((8, 1024), 3, "high"), ((8, 2, 512), 2, "split")],
        "reduce": [((8, 1024), None), ((8, 1024), "int"),
                   ((8, 2, 512), (8, 2, 1))],
    }
    samples = {"mul": ((8, 512), (8, 512)), "add": ((8, 512), (8, 1)),
               "sub": ("int", (8, 512)), "bind": ((8, 512), "low", "int"),
               "evals": ((8, 512), 3, "high"), "reduce": ((8, 512), (8, 1))}
    for form, keys in small.items():
        for key in keys:
            args = k1_args(form, key, draw_edge, draw_edge_int,
                           draw_edge_sums)
            k1_err[form] = max(k1_err[form], compare_k1(
                kernels, form, args, f"on 0/1/r-1 at {key}"))
        key = samples[form]
        args = k1_args(form, key, draw, draw_int, draw_sums)
        out = k1_call(kernels, form, args)
        shape = tuple(torch.broadcast_shapes(
            *(a.shape for a in args if isinstance(a, torch.Tensor))))
        check(words_to_ints(out.reshape(8, -1))
              == k1_python(kernels, form, args, shape),
              f"K1 {form} disagrees with Python ints at {key}")
    max_err = max(k1_err.values())
    print("[kernel] K1 == its plain version bit for bit in every form (N = "
          "2^20, 0/1/r-1); 512-element samples == Python ints", flush=True)

    # ---- 4. K2 vs plain: 2 and 3 factors, every order --------------------
    print(f"[phase] 4 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    k2_err = 0
    k2_times = {}
    for nf in (2, 3):
        for order in kernels.ORDERS:
            tag = f"nf={nf} {order}"
            for log_t in (K2_SMALL_LOG_T, K2_LOG_T):
                polys = tuple(rand_field((8, 1 << log_t), gen, dev)
                              for _ in range(nf))
                r = rand_field((8, 1), gen, dev)
                got = kernels.product_round(polys, r, order)
                k2_err = max(k2_err, k2_error(
                    got, kernels.product_round_plain(polys, r, order),
                    f"({tag}, T = 2^{log_t})"))
                k2_err = max(k2_err, k2_error(
                    got, kernels.product_round(polys, ops.unpack_ints(r)[0],
                                               order),
                    f"({tag}, T = 2^{log_t}, device r vs r by value)"))
            # pass alone, pass + finish, plain at 2^18 (the last inputs)
            k2_times[(nf, order)] = t = time_k2(kernels, ops, polys, r, order)
            print(f"[kernel] product_round {tag} T=2^{K2_LOG_T}: pass "
                  f"{t['pass_ms']:.4f} ms + finish {t['finish_ms']:.4f} ms "
                  f"(kernel-only), wrapper {t['wrapper_ms']:.4f} ms (device "
                  f"r {t['wrapper_dev_ms']:.4f} ms), plain "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']}), {t['blocks']} blocks", flush=True)
            del polys
            # 0, 1 and r-1 in every factor and as the challenge
            vals = torch.randint(0, 3, (nf, 1 << 10), generator=gen,
                                 device=dev)
            polys = tuple(ints_to_words([edge[int(v)] for v in row], dev)
                          for row in vals.tolist())
            for x in edge:
                r = ints_to_words([x], dev)
                got = kernels.product_round(polys, r, order)
                k2_err = max(k2_err, k2_error(
                    got, kernels.product_round_plain(polys, r, order),
                    f"({tag}, 0/1/r-1, r = {x % 1000})"))
                k2_err = max(k2_err, k2_error(
                    got, kernels.product_round(polys, ops.unpack_ints(r)[0],
                                               order),
                    f"({tag}, 0/1/r-1, r = {x % 1000}, device r vs by "
                    "value)"))
            small = tuple(rand_field((8, 8), gen, dev) for _ in range(nf))
            r = rand_field((8, 1), gen, dev)
            msg, bound = kernels.product_round(small, r, order)
            want_msg, want_bound = k2_python_ints(kernels, ops, small, r,
                                                  order)
            check((msg is None and want_msg is None)
                  or ops.unpack_ints(msg.reshape(8, -1)) == want_msg,
                  f"K2 message disagrees with Python ints ({tag})")
            check((bound is None and want_bound is None)
                  or [ops.unpack_ints(b) for b in bound] == want_bound,
                  f"K2 binds disagree with Python ints ({tag})")
    # the round-step entry point's size, where launch latency rules
    polys = tuple(rand_field((8, 1 << K2_SMALL_LOG_T), gen, dev)
                  for _ in range(3))
    r = rand_field((8, 1), gen, dev)
    k2_small = time_k2(kernels, ops, polys, r, "message_bind")
    print(f"[kernel] product_round nf=3 message_bind T=2^{K2_SMALL_LOG_T}: "
          f"pass {k2_small['pass_ms']:.4f} ms + finish "
          f"{k2_small['finish_ms']:.4f} ms (kernel-only), wrapper "
          f"{k2_small['wrapper_ms']:.4f} ms, plain "
          f"{k2_small['plain_ms']:.4f} ms, bound {k2_small['bound_ms']:.4f} "
          f"ms, {k2_small['blocks']} blocks", flush=True)
    print(f"[kernel] K2 == product_round_plain bit for bit (2 and 3 factors, "
          f"every order, T=2^{K2_SMALL_LOG_T} and 2^{K2_LOG_T}, 0/1/r-1); "
          "T=8 == Python ints; a device r (by pointer) == the same r by "
          "value in every order", flush=True)

    # ---- 4b. K4 vs plain: seeded stages, edge values; its time ----------
    print(f"[phase] 4b starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    # the card tests' stages (1-4 instances of degrees 1-3, inactive rounds,
    # claims 0 and p - 1, edge evals, states from a real transcript; and
    # the wide ones, 33-64 instances, 1-3 compressed coefficients)
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import K4_WIDE, k4_case, run_k4_case
    k4_err, k4_rounds, k4_top, k4_most = 0, 0, 0, 0
    for seed, n_inst in [(s, 0) for s in range(K4_SEEDS)] + list(K4_WIDE):
        case = k4_case(seed, n_inst)
        got = run_k4_case(case, dev, dt.round_tail)
        want = run_k4_case(case, dev, dt.round_tail_plain)
        for rnd, (g, w) in enumerate(zip(got, want)):
            k4_err = max(k4_err, int((g.to(torch.int64)
                                      - w.to(torch.int64)).abs().max()))
            check(torch.equal(g, w), f"K4 disagrees with its plain version "
                  f"(seed {seed}, {len(case['degrees'])} instances, round "
                  f"{rnd})")
            # the squeeze's first 16 bytes, little-endian: bits 125-127
            k4_top += (int(g[3]) >> 29) & 7 == 7
        k4_rounds += len(got)
        k4_most = max(k4_most, len(case["degrees"]))
    check(k4_top > 0, "no seeded round squeezed a challenge whose top three "
          "bits are set")
    check(k4_most == 64, "no seeded stage had 64 instances")
    print(f"[kernel] K4 == round_tail_plain bit for bit after each of "
          f"{k4_rounds} rounds of {K4_SEEDS + len(K4_WIDE)} seeded stages "
          f"(1-4 and {', '.join(str(n) for _, n in K4_WIDE)} instances; "
          f"{k4_top} squeezes with the top three bits set)", flush=True)
    k4_times = time_k4(k4p, dt, dev, k4_builds.get("old", (None,))[0])
    for name, t in k4_times.items():
        old_runs = t["runs"].get("old")
        degs = "/".join(map(str, sorted(set(t["degrees"]))))

        def runs(rs):
            return (", ".join(f"{r['ms']:.5f}" for r in rs)
                    + " ms kernel-only, queued "
                    + ", ".join(f"{r['queued_ms']:.5f}" for r in rs
                                if "queued_ms" in r)
                    + " ms, wrapper "
                    + ", ".join(f"{r['wrapper_ms']:.5f}" for r in rs))
        print(f"[kernel] K4 round tail at {name} ({len(t['degrees'])} "
              f"instance(s) of degree {degs}, n_c {t['n_c']}): "
              + runs(t["runs"]["new"]) + " ms a launch"
              + ("" if old_runs is None else
                 "; one-warp K4 " + runs(old_runs)
                 + " ms (turns: old, new, new, old)")
              + (f"; plain {t['plain_ms']:.3f} ms" if "plain_ms" in t else "")
              + f"; bound {t['bound_ms']:.7f} ms ({t['bound_by']}; "
              "latency-bound)", flush=True)
    if "old" not in k4_builds:
        print("[kernel] the one-warp K4 is timed beside it with --old-k4 TREE "
              "(an unpacked tree of its commit)", flush=True)
    # K4 by part (its stamped build), the micro-kernels and the floor
    k4_lib = k4_builds["stamped"][0]
    k4_mhz = k4p.clock_mhz(k4_lib, dev)
    k4_micro = k4p.micro(k4_lib, dev, old=False)
    check(k4_micro["agree"], "K4's compressions on one and four lanes "
          "disagree")
    k4_launch = k4p.launch_cost(k4_lib, dev, kernels.RoundTail)
    print(f"[k4] SM clock {k4_mhz:.0f} MHz; cycles, code warm: a "
          f"compression unrolled on one lane {k4_micro['compress_1lane']:.1f}"
          f", on four lanes with the rounds a loop "
          f"{k4_micro['compress_4lanes_rolled']:.1f}, K4's own (four "
          f"lanes, unrolled) {k4_micro['compress_k4']:.1f}; a "
          "Montgomery product "
          f"{k4_micro['mont_mul8']:.1f}; a dependent ALU instruction "
          f"{k4_micro['alu_op']:.2f}; an empty kernel with K4's record "
          f"{k4_launch['ms']:.5f} ms kernel-only, "
          f"{k4_launch['per_launch_ms']:.5f} ms a launch back to back",
          flush=True)
    k4_parts, k4_floor = {}, {}
    for name, degrees in k4p.SHAPES:
        part = k4p.by_part(k4_lib, dev, degrees, dt.tail_record)
        k4_parts[name] = part
        k4_floor[name] = k4p.chain_floor(degrees, part["n_c"], k4_micro,
                                         k4_launch["ms"], k4_mhz)
        print(f"[k4] by part at {name}, cycles from entry: "
              + ", ".join(f"{k} {v}" for k, v in part["cycles"].items())
              + f"; dependent-chain floor {k4_floor[name]['ms']:.5f} ms "
              f"({k4_floor[name]['warm_ms']:.5f} with its compressions at "
              "their warm cycles)",
              flush=True)

    # ---- 5. round-step path and a chained ProductSumcheck ----------------
    print(f"[phase] 5 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    T = 1 << K2_LOG_T
    chain = [tuple(rand_field((8, T), gen, dev) for _ in range(3))]
    rs = [rand_field((8, 1), gen, dev) for _ in range(K2_LOG_T)]
    msgs = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for r in rs:
        msg, bound = round_step(chain[-1], r)
        msgs.append(msg)
        chain.append(bound)
    torch.cuda.synchronize()
    t_chain = time.perf_counter() - t0
    k2_round_launches = kernels.product_round.launches
    k1_round_launches = sum(kernels.k1_launches().values())
    check(k2_round_launches == K2_LOG_T,
          f"round_step launched K2 {k2_round_launches} times in "
          f"{K2_LOG_T} rounds")
    check(chain[-1][0].shape == (8, 1), "chained run did not end at T = 1")
    for i, r in enumerate(rs):
        want = kernels.product_round_plain(chain[i], r, "message_bind")
        k2_err = max(k2_err, k2_error((msgs[i], chain[i + 1]), want,
                                      f"in chained round {i}"))
    print(f"[path] round_step 2^{K2_LOG_T} -> 2: {K2_LOG_T} rounds in "
          f"{t_chain:.4f}s, K2 launches {k2_round_launches}, K1 launches "
          f"{k1_round_launches}; every round == product_round_plain bit for "
          "bit", flush=True)
    del chain, msgs

    factors = [rand_field((8, T), gen, dev) for _ in range(3)]
    inst = ProductSumcheck(factors)
    card_msgs = []
    live_message = inst.message_evals_dev
    inst.message_evals_dev = lambda rnd: card_msgs.append(
        live_message(rnd)) or card_msgs[-1]
    torch.cuda.synchronize()
    kernels.product_round.launches = 0
    t0 = time.perf_counter()
    proof, r_sc = BatchedSumcheck.prove([inst], OpeningAccumulator(),
                                        Blake2bTranscript(b"chip_smoke"))
    t_sumcheck = time.perf_counter() - t0
    k2_sumcheck_launches = kernels.product_round.launches
    check(k2_sumcheck_launches == K2_LOG_T + 1,
          f"ProductSumcheck launched K2 {k2_sumcheck_launches} times in "
          f"{K2_LOG_T} rounds (want {K2_LOG_T + 1})")
    polys, plain_msgs = tuple(factors), []
    for j, rj in enumerate([None] + r_sc):
        order = ("message" if j == 0 else "bind" if j == K2_LOG_T
                 else "bind_message")
        msg, bound = kernels.product_round_plain(polys, rj, order)
        polys = bound or polys
        if msg is not None:
            plain_msgs.append(msg)
    check(len(card_msgs) == len(plain_msgs) == K2_LOG_T
          and all(torch.equal(c, w) for c, w in zip(card_msgs, plain_msgs)),
          "chained ProductSumcheck messages differ from the plain chain")
    check(inst.final_claims == [ops.unpack_ints(p)[0] for p in polys],
          "chained ProductSumcheck final claims differ from the plain chain")
    check(BatchedSumcheck.verify(
        proof, [VerifierProductSumcheck(K2_LOG_T, inst.input_claim(None),
                                        inst.final_claims)],
        OpeningAccumulator(), Blake2bTranscript(b"chip_smoke")) == r_sc,
        "the chained ProductSumcheck did not verify")
    print(f"[path] ProductSumcheck 3 x 2^{K2_LOG_T}: {K2_LOG_T} rounds in "
          f"{t_sumcheck:.4f}s, K2 launches {k2_sumcheck_launches}; every "
          "message and the final claims == the plain chain; verified",
          flush=True)
    del factors, inst, card_msgs, plain_msgs, polys

    # ---- 6. main path: sha2-chain through prove on the card --------------
    print(f"[phase] 6 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    tr = sha2_chain_trace()          # raises if the chain's output is wrong
    t_trace = time.perf_counter() - t0
    print(f"[path] sha2-chain chain={SHA2_CHAIN}: {tr.length} cycles, "
          f"padded {tr.padded_length}, traced in {t_trace:.2f}s", flush=True)
    check(required_num_vars(tr.padded_length, 0, 0) == setup.num_vars,
          f"the setup does not fit the trace's {tr.padded_length} cycles")

    # K1's and K2's launches, per form, and every K1 launch's shapes: set to
    # 0 just before the main path and read just after
    # and the plain versions' torch limb arithmetic must not run there
    plain_calls = collections.Counter()
    plain = {n: getattr(kernels, n)
             for n in ("_carry", "_sub_p_select", "mont_mul_plain")}

    def counted(name, fn):
        def call(*args):
            plain_calls[name] += 1
            return fn(*args)
        return call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    kernels.record = []
    for name, fn in plain.items():
        setattr(kernels, name, counted(name, fn))
    # Dory's spans (the span profiler that `open` and `open_rlc` report to)
    dory_prof = profiling.PROFILER = profiling.Profiler()
    # the one-hot matrices' positions, for phase 8b's device tier
    onehot_positions = []
    commit_many = scheme_mod.DoryScheme.commit_sparse_many

    def capture(self, named):
        onehot_positions.extend(p for _, p in named)
        return commit_many(self, named)
    scheme_mod.DoryScheme.commit_sparse_many = capture
    # the device tier's stages: each one's round loop and finals (from its
    # first message to its fetch) under the sync debug mode, every
    # synchronizing CUDA call inside recorded with the line that made it;
    # each batched stage's tier, rounds and the device tier's spans before
    # it (`fused.device_tier` is asked once a stage)
    main_syncs = []
    tier_calls = []
    real_tier = fused.device_tier

    def watched_tier(instances):
        on = real_tier(instances)
        tier_calls.append((on, max(i.num_rounds for i in instances),
                           len(instances),
                           {n: dory_prof.total(n) for n in FUSED_SPANS}))
        return on
    fused.device_tier = watched_tier
    fused.fetches = 0
    main_peaks = {}
    try:
        with stage1_peaks(prover_mod, main_peaks), \
                watch_loop_syncs(fused, main_syncs):
            t0 = time.perf_counter()
            proof, stage_s, stage_lines, stage_launches = timed_stages(
                lambda: prove(tr, setup=setup, device="cuda"))
            t_prove = time.perf_counter() - t0
    finally:
        k1_counts = kernels.k1_launches()
        k2_launches = kernels.product_round.launches
        k3_counts = kernels.k3_launches()
        k4_launches = kernels.k4_launches()
        tier_fetches = fused.fetches
        fused.device_tier = real_tier
        tier_spans_end = {n: dory_prof.total(n) for n in FUSED_SPANS}
        records, kernels.record = kernels.record, None
        for name, fn in plain.items():
            setattr(kernels, name, fn)
        profiling.PROFILER = profiling.Profiler(enabled=False)
        scheme_mod.DoryScheme.commit_sparse_many = commit_many
    launches = sum(k1_counts.values())
    peak = max(main_peaks["before_s1"], torch.cuda.max_memory_allocated(dev))
    print(stage_lines, end="")
    log_t = tr.padded_length.bit_length() - 1
    check(all(k1_counts.values()),
          f"a K1 form was not launched on the main path: {k1_counts}")
    check(len(records) == launches, "K1's launch record missed launches")
    check(not plain_calls, "torch limb arithmetic ran on the card's path: "
          f"{dict(plain_calls)}")
    # stage 1s and each ra-virtualization instance of stage 6v (one per
    # full-ra claim of a space wider than one chunk): the first message,
    # log T - 1 bind + message passes, the last bind
    n6v = sum(len(src) for log_k, src in ((proof.ram_log_K, RAM_RA_SOURCES),
                                          (proof.bytecode_log_K,
                                           BC_RA_SOURCES))
              if d_chunks(log_k) == 2)
    check(all(d_chunks(k) <= 2 for k in (proof.ram_log_K,
                                          proof.bytecode_log_K)),
          "a stage-6v instance has more than 3 factors: off K2")
    # stage 7: each K group's Hamming-weight instance runs its log T cycle
    # rounds on K2, plus the last bind for a one-member group
    widths = ([7] * 3 + block_widths(proof.ram_log_K)
              + block_widths(proof.bytecode_log_K) + [8] * 16)
    n7 = sum(log_t + (widths.count(w) == 1) for w in set(widths))
    check(stage_launches["stage1s-shift"]["k2"] == log_t + 1
          and stage_launches["stage6v-ra-virtual"]["k2"]
          == n6v * (log_t + 1)
          and stage_launches["stage7-booleanity"]["k2"] == n7
          and stage_launches["stage8-reduction"]["k2"] > 0,
          f"K2 per stage: {stage_launches}")
    check(k2_launches == sum(v["k2"] for v in stage_launches.values()),
          f"K2 launched {k2_launches} times on the main path, "
          f"{stage_launches} by stage")
    # every batched stage but s5i on the device tier: one K4 launch a round
    # of its longest instance (the rounds formula below, which the proof's
    # round polynomials must also give), one device-to-host fetch a stage,
    # and no synchronizing call from a stage's first message to its fetch
    ram_k, bc_k = proof.ram_log_K, proof.bytecode_log_K
    tier_rounds = {"stage1-spartan": log_t + 1, "stage1s-shift": log_t,
                   "stage2-reg-rw": log_t + 7, "stage3-reg-val": log_t + 7,
                   "stage4-5-ram": 2 * (log_t + ram_k),
                   "stage6-bytecode": log_t + max(bc_k, 7),
                   "stage6v-ra-virtual": log_t if n6v else 0,
                   "stage7-booleanity": log_t + max(widths),
                   "stage8-reduction": log_t + max(widths)}
    polys_rounds = {
        "stage1-spartan": len(proof.stage1_polys),
        "stage1s-shift": len(proof.shift_polys),
        "stage2-reg-rw": len(proof.stage2_polys),
        "stage3-reg-val": len(proof.stage3_polys),
        "stage4-5-ram": len(proof.stage4_polys) + len(proof.stage5_polys),
        "stage6-bytecode": len(proof.stage6_polys),
        "stage6v-ra-virtual": len(proof.stage6v_polys),
        "stage7-booleanity": len(proof.stage7_polys),
        "stage8-reduction": len(proof.stage8_polys)}
    check(polys_rounds == tier_rounds, f"rounds by stage: the proof's "
          f"{polys_rounds}, the formula's {tier_rounds}")
    tier_stages = [k for k, v in tier_rounds.items() if v]
    k4_by_stage = {k: v["k4"] for k, v in stage_launches.items() if v["k4"]}
    check(k4_by_stage == {k: tier_rounds[k] for k in tier_stages}
          and k4_launches == sum(tier_rounds.values()),
          f"K4 launched {k4_launches} times, {k4_by_stage} by stage (want "
          f"{tier_rounds})")
    n_tier = 10 if n6v else 9
    stage_names = ZK_LABELS if n6v else [x for x in ZK_LABELS if x != "s6v"]
    check([on for on, *_ in tier_calls] == [x != "s5i" for x in stage_names],
          f"the tier of each batched stage: {[c[:3] for c in tier_calls]}")
    check(tier_fetches == n_tier, f"the device tier made {tier_fetches} "
          f"device-to-host fetches (want one a stage, {n_tier})")
    check(not main_syncs, f"the device tier's stages synchronized "
          f"{len(main_syncs)} times, at {collections.Counter(main_syncs)}")
    check(list(stage_s) == DORY_STAGES, f"stage lines: {stage_s}")
    check([e["stage"] for e in proof.fs_tape] == DORY_STAGES[1:],
          f"FS tape: {proof.fs_tape}")
    check(set(proof.commitments) == set(committed_poly_names(
        d_chunks(proof.ram_log_K), d_chunks(proof.bytecode_log_K)))
          and "joint" in proof.opening_proofs,
          f"commitments {sorted(proof.commitments)}, opening proofs "
          f"{sorted(proof.opening_proofs)}")
    # Dory's G1 work runs on K3 (one-hot tier 1, the dense commits, the
    # opening's phase B), and the Dory stages launch no K1 or K2
    dory_k3 = {s: {f: c for f, c in stage_launches[s]["k3"].items() if c}
               for s in ("stage0-commit", "stage8-openings")}
    check(all(not any(stage_launches[s]["k1"].values())
              and stage_launches[s]["k2"] == 0 for s in dory_k3),
          f"a Dory stage launched K1 or K2: {stage_launches}")
    check(all(dory_k3.values()) and set().union(*dory_k3.values()) >= {
        "bucket_sum", "bucket_reduce", "scalar_mul", "add", "normalize"},
          f"the Dory stages' K3 launches: {dory_k3}")
    check(sum(k3_counts.values()) == sum(sum(v.values())
                                         for v in dory_k3.values()),
          f"K3 launched outside the Dory stages: {k3_counts}, {dory_k3}")
    t0 = time.perf_counter()
    ok = verify(proof, PublicIO.from_trace(tr), setup=setup)
    t_verify = time.perf_counter() - t0
    check(ok is True, "verify did not accept")
    cycles_per_s = tr.length / t_prove
    spans = {name: dory_prof.total(name) for name in DORY_SPANS}
    check(all(v > 0 for v in spans.values()), f"Dory spans: {spans}")
    # the setup's point encodings, made anew by each prove's Dory instance
    # (nested in commit.onehot, commit.tier2 and the opening's rounds)
    t_encode = dory_prof.total("encode.setup")
    shapes = collections.Counter(records)
    # the address-phase scale of s2-s5 is in the reduce form's finish
    check(shapes[("mul", ((8, 3, 1), (8, 1, 1)))] == 0,
          "the path still multiplies (8, 3, 1) messages by a scale")
    print(f"[path] prove(setup=nu {setup.nu}, sigma {setup.sigma}) "
          f"{t_prove:.3f}s = {cycles_per_s:.1f} cycles/s end to end ("
          + ", ".join(f"{k} {v:.3f}s" for k, v in stage_s.items())
          + f"), peak allocated {peak / 2**30:.3f} GiB, K1 launches "
          f"{launches} {k1_counts}, {len(shapes)} launch shapes, K2 launches "
          f"{k2_launches} (stage 1s and {n6v} stage-6v instances, {log_t} "
          f"rounds each; stage 7 {n7}, stage 8 "
          f"{stage_launches['stage8-reduction']['k2']}; RAM log K "
          f"{proof.ram_log_K}, bytecode log K {proof.bytecode_log_K}); "
          f"verify(setup) accepted in {t_verify:.3f}s", flush=True)
    t_dory = stage_s["stage0-commit"] + stage_s["stage8-openings"]
    print("[dory] spans (s, summed over calls): " + ", ".join(
        f"{n} {v:.4f}" for n, v in spans.items()) + f"; stage0-commit "
        f"{stage_s['stage0-commit']:.3f}s, stage8-openings "
        f"{stage_s['stage8-openings']:.3f}s of prove {t_prove:.3f}s "
        f"({t_dory / t_prove:.1%}); encode.setup {t_encode:.4f}s "
        f"({t_encode / t_prove:.1%} of prove, Gamma1's pack to the card "
        "included)", flush=True)
    print(f"[dory] K3 launches by Dory stage: {dory_k3} (K3 on the whole "
          f"prove: {sum(k3_counts.values())})", flush=True)

    # the same prove with Dory's G1 work on the native library (the route
    # argument) and every stage on the host engine (every slot forced
    # there through the backend seam), held byte for byte against the main
    # run's proof
    native_scheme = scheme_mod.DoryScheme(setup, "cuda", _k3=False)
    host_tier = JoltBackend.default().with_every_slot("host")
    nprof = profiling.PROFILER = profiling.Profiler()
    kernels.reset_launches()
    set_backend(host_tier)
    try:
        t0 = time.perf_counter()
        nat_proof, nat_s, _, nat_launches = timed_stages(
            lambda: prove(tr, setup=native_scheme, device="cuda"))
        t_native_prove = time.perf_counter() - t0
    finally:
        set_backend(None)
        nat_k3 = kernels.k3_launches()
        nat_k4 = kernels.k4_launches()
        profiling.PROFILER = profiling.Profiler(enabled=False)
    check(serialize_proof(nat_proof) == serialize_proof(proof)
          and nat_proof.fs_tape == proof.fs_tape,
          "the main run's proof (K3 route, the device tier) differs from "
          "the native route's (every stage on the host engine) at 2^18")
    check(not any(nat_k3.values()), f"the native route launched K3: {nat_k3}")
    check(nat_k4 == 0 and fused.fetches == tier_fetches,
          f"the host-tier run launched K4 {nat_k4} times")
    check(all(nat_launches[k]["k1"] == stage_launches[k]["k1"]
              and nat_launches[k]["k2"] == stage_launches[k]["k2"]
              for k in tier_stages),
          f"K1/K2 launches of a stage differ between the tiers: "
          f"{[(nat_launches[k], stage_launches[k]) for k in tier_stages]}")
    fused_spans = {n: dory_prof.total(n) for n in FUSED_SPANS}
    print(f"[tier] K4 {k4_launches} launches ({k4_by_stage}) == the "
          f"longest instance's rounds; {tier_fetches} fetches; 0 syncs from "
          "a stage's first message to its fetch; proof bytes and FS tape == "
          f"the host engine's; peak allocated {peak / 2**30:.3f} GiB; "
          "device tier's spans (s, all stages): " + ", ".join(
              f"{n} {v:.4f}" for n, v in fused_spans.items()), flush=True)
    for label in tier_stages:
        print(f"[tier] {label}: device tier (main run) {stage_s[label]:.4f}"
              f"s, host engine (native-route run) {nat_s[label]:.4f}s; K4 "
              f"{stage_launches[label]['k4']}, K1 "
              f"{sum(stage_launches[label]['k1'].values())}, K2 "
              f"{stage_launches[label]['k2']} (both tiers)", flush=True)
    ends = [c[3] for c in tier_calls[1:]] + [tier_spans_end]
    tier_stage_spans = {}
    for name, (on, rounds, n_inst, before), after in zip(
            stage_names, tier_calls, ends):
        tier_stage_spans[name] = {n: after[n] - before[n] for n in FUSED_SPANS}
        print(f"[tier] {name}: {'device tier' if on else 'host engine'}, "
              f"{n_inst} instances, {rounds} rounds; spans (s) " + ", ".join(
                  f"{n} {v:.4f}" for n, v in tier_stage_spans[name].items()),
              flush=True)
    nat_spans = {name: nprof.total(name) for name in DORY_SPANS}
    print(f"[dory] native route (the same prove, Dory's G1 work on the "
          f"native library): prove {t_native_prove:.3f}s, stage0-commit "
          f"{nat_s['stage0-commit']:.3f}s, stage8-openings "
          f"{nat_s['stage8-openings']:.3f}s; spans " + ", ".join(
              f"{n} {v:.4f}" for n, v in nat_spans.items())
          + f", encode.setup {nprof.total('encode.setup'):.4f}; proof "
          f"bytes and FS tape == the K3 route's ({len(serialize_proof(proof))}"
          " B)", flush=True)
    del nat_proof

    # a run under the profiler, at setup=None so that the card's stages
    # compare with the runs before Dory: each stage's device time and busy
    # share on the device tier, and the device kernels by name (those of
    # no port kernel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_s, _, _ = timed_stages(lambda: prove(tr, device="cuda"))
        torch.cuda.synchronize()
    check(list(prof_s) == STAGES, f"profiled stage lines: {prof_s}")
    dev_s = stage_device_s(prof)
    tier_busy = {}
    for label in tier_stages:
        tier_busy[label] = {
            "device_tier_s": prof_s[label],
            "device_tier_device_s": dev_s.get(label, 0.0)}
        b = tier_busy[label]
        print(f"[tier] {label} profiled: device tier {b['device_tier_s']:.4f}"
              f"s, device {b['device_tier_device_s']:.4f}s, busy "
              f"{b['device_tier_device_s'] / b['device_tier_s']:.1%}",
              flush=True)
    for label in STAGES:
        n = stage_launches[label]
        print(f"[stage] {label}: {stage_s[label]:.4f}s timed; profiled "
              f"{prof_s[label]:.4f}s, device {dev_s.get(label, 0.0):.4f}s, "
              f"busy {dev_s.get(label, 0.0) / prof_s[label]:.1%}; K1 "
              f"{sum(n['k1'].values())} {n['k1']}, K2 {n['k2']}, K4 "
              f"{n['k4']}", flush=True)
    print(f"[stage] prove profiled {sum(prof_s.values()):.3f}s, busy "
          f"{sum(dev_s.values()) / sum(prof_s.values()):.1%}", flush=True)
    census = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            census[e.name] += 1
    own = ("k1_", "round_kernel", "finish_kernel", "k4_round_tail")
    others = {k: c for k, c in census.items()
              if not any(o in k for o in own) and "Memcpy" not in k
              and "Memset" not in k}
    copies = {k: c for k, c in census.items() if "Memcpy" in k}
    n_other = sum(others.values())
    print(f"[path] device kernels on prove (profiled run): "
          f"{sum(c for k, c in census.items() if 'k1_' in k)} K1, "
          f"{sum(c for k, c in census.items() if any(o in k for o in own[1:3]))}"
          f" K2, {sum(c for k, c in census.items() if own[3] in k)} K4, "
          f"{n_other} others, copies {copies}; the most frequent "
          "others: " + "; ".join(
              f"{k[:70]} x{c}" for k, c in
              sorted(others.items(), key=lambda kv: -kv[1])[:6]), flush=True)

    # each form vs plain at the main path's largest shape and at the one
    # with the most work (launches x bound)
    from jolt_tpu_torch.workload import k1_bound_ms
    k1_forms = {}
    for form in kernels.FORMS:
        keys = {k: c for (f, k), c in shapes.items() if f == form}
        largest = max(keys, key=lambda k: k1_bound_ms(form, k)[0])
        heaviest = max(keys, key=lambda k: keys[k] * k1_bound_ms(form, k)[0])
        entry = {"form": form, "launches": k1_counts[form]}
        for tag, key in (("largest", largest), ("heaviest", heaviest)):
            args = k1_args(form, key, draw, draw_int, draw_sums)
            k1_err[form] = max(k1_err[form], compare_k1(
                kernels, form, args, f"at the path's {tag} shape {key}"))
            t = time_k1(kernels, form, args, key)
            entry[tag] = {"key": repr(key), "launches": keys[key], **t}
            print(k1_line(form, key, t, f"{tag} path shape ({keys[key]} "
                          "launches) "), flush=True)
            del args
        entry.update(max_abs_err=k1_err[form], n20=k1_n20[form],
                     **{k: entry["heaviest"][k] for k in
                        ("ms", "plain_ms", "bound_ms", "bound_by")})
        k1_forms[form] = entry
    max_err = max(k1_err.values())
    # K1's headline: the form whose heaviest path shape has the most work
    head = max(k1_forms.values(),
               key=lambda e: e["heaviest"]["launches"] * e["bound_ms"])

    # ---- 6b. the zk and committed-image paths at full width --------------
    print(f"[phase] 6b starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    # each path's launch counts set to 0 just before it and read just after
    def flag_path(**flags):
        kernels.reset_launches()
        prof = profiling.PROFILER = profiling.Profiler()
        try:
            t0 = time.perf_counter()
            out, s, _, launches_s = timed_stages(
                lambda: prove(tr, setup=setup, device="cuda", **flags))
            t = time.perf_counter() - t0
        finally:
            k1 = kernels.k1_launches()
            k2 = kernels.product_round.launches
            profiling.PROFILER = profiling.Profiler(enabled=False)
        return out, t, s, launches_s, k1, k2, prof

    def stage_cmp(s):
        return ", ".join(f"{k} {v:.3f}s (plain {stage_s[k]:.3f}s)"
                         if k in stage_s else f"{k} {v:.3f}s"
                         for k, v in s.items())

    io_main = PublicIO.from_trace(tr)
    zk_proof, t_zk, zk_s, zk_launches, zk_k1, zk_k2, zk_prof = flag_path(
        zk=True, zk_rng=random.Random(SEED))
    check(sorted(zk_proof.zk_commitments) == sorted(ZK_LABELS),
          f"zk round commitments for {sorted(zk_proof.zk_commitments)}")
    check(all(getattr(zk_proof, f) == [] for f in CLEAR_POLYS),
          "a zk proof carries clear round polynomials")
    check(zk_proof.zk_blindfold is not None, "the zk proof has no BlindFold")
    check(list(zk_s) == DORY_STAGES + ["blindfold"],
          f"zk stage lines: {zk_s}")
    # K1 and K2 as in the plain run, stage by stage; K3 commits the same
    # polynomials in stage 0 (the opening's MSMs hold other scalars, so
    # their bucket levels may differ)
    check(zk_k1 == k1_counts and zk_k2 == k2_launches
          and all(zk_launches[k][kk] == stage_launches[k][kk]
                  for k in stage_launches for kk in ("k1", "k2"))
          and zk_launches["stage0-commit"]["k3"]
          == stage_launches["stage0-commit"]["k3"]
          and any(zk_launches["stage8-openings"]["k3"].values()),
          f"zk launched K1 {zk_k1} and K2 {zk_k2} (plain {k1_counts}, "
          f"{k2_launches}); by stage {zk_launches}")
    # zk's stages run the host engine's committed rounds: no K4
    check(not any(v["k4"] for v in zk_launches.values()),
          f"the zk run launched K4: {zk_launches}")
    n_comms = sum(len(v) for v in zk_proof.zk_commitments.values())
    t_commit = zk_prof.total("zk.commit")
    t0 = time.perf_counter()
    check(verify(zk_proof, io_main, setup=setup) is True,
          "verify rejected the zk proof")
    t_zk_verify = time.perf_counter() - t0
    print(f"[zk] prove(setup, zk=True) {t_zk:.3f}s = "
          f"{tr.length / t_zk:.1f} cycles/s (plain {t_prove:.3f}s = "
          f"{cycles_per_s:.1f}); {n_comms} round commitments "
          f"(zk.commit {t_commit:.4f}s), blindfold {zk_s['blindfold']:.3f}s; "
          f"K1 {sum(zk_k1.values())} and K2 {zk_k2} launches == plain; "
          f"verify(setup) {t_zk_verify:.3f}s (plain {t_verify:.3f}s); "
          f"{len(serialize_proof(zk_proof))} B (plain "
          f"{len(serialize_proof(proof))} B)", flush=True)
    print(f"[zk] stages: {stage_cmp(zk_s)}", flush=True)

    ci_proof, t_ci, ci_s, ci_launches, ci_k1, ci_k2, _ = flag_path(
        committed_image=True)
    pi_m = len(image_words(tr.code)).bit_length() - 1
    check("program_image_init" in ci_proof.stage7_openings
          and "program_image" in ci_proof.commitments
          and ci_proof.program_image_claim is not None,
          "the committed-image proof lacks its image claim or opening")
    check(list(ci_s) == DORY_STAGES, f"image stage lines: {ci_s}")
    image_k2 = {"stage7-booleanity": pi_m + 1, "stage8-reduction": pi_m + 1}
    check(all(ci_launches[k]["k2"] == v["k2"] + image_k2.get(k, 0)
              for k, v in stage_launches.items())
          and ci_k2 == k2_launches + 2 * (pi_m + 1),
          f"image run K2 {ci_k2} (plain {k2_launches} + 2 x {pi_m + 1}); "
          f"by stage {ci_launches}")
    check(all(ci_launches[k]["k1"] == v["k1"]
              for k, v in stage_launches.items() if k not in image_k2),
          f"image run K1 outside stages 7 and 8: {ci_launches}")
    check(all(ci_launches[k]["k4"] == v["k4"]
              for k, v in stage_launches.items())
          and ci_launches["stage7-booleanity"]["k4"] > 0,
          f"image run K4 differs from the plain run's: {ci_launches}")
    k1_extra = {k: sum(ci_launches[k]["k1"].values())
                - sum(stage_launches[k]["k1"].values()) for k in image_k2}
    verifier_mod._PI_COMMIT_CACHE.clear()
    t0 = time.perf_counter()
    check(verify(ci_proof, io_main, setup=setup) is True,
          "verify rejected the committed-image proof")
    t_ci_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(verify(ci_proof, io_main, setup=setup) is True,
          "verify rejected the committed-image proof (cached commitment)")
    t_ci_cached = time.perf_counter() - t0
    print(f"[image] prove(setup, committed_image=True) {t_ci:.3f}s = "
          f"{tr.length / t_ci:.1f} cycles/s (plain {t_prove:.3f}s); image "
          f"{len(image_words(tr.code))} words ({len(tr.code)} code bytes, "
          f"{pi_m} rounds); K2 {ci_k2} = plain {k2_launches} + 2 x "
          f"{pi_m + 1}; K1 {sum(ci_k1.values())} (plain {launches}; extra "
          f"in stages 7/8: {k1_extra}); verify(setup) {t_ci_verify:.3f}s "
          f"recomputing the image commitment, {t_ci_cached:.3f}s cached "
          f"(plain {t_verify:.3f}s)", flush=True)
    print(f"[image] stages: {stage_cmp(ci_s)}", flush=True)
    del zk_proof, ci_proof

    # ---- 6c. stage 1 streamed: 2^18 forced, 2^20 at its threshold --------
    print(f"[phase] 6c starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    w18 = watched_prove(lambda: prove(tr, setup=setup, device="cuda",
                                      _stream_stage1=True),
                        kernels, fused, prover_mod, so)
    check(serialize_proof(w18["proof"]) == serialize_proof(proof)
          and w18["proof"].fs_tape == proof.fs_tape,
          "the forced-stream prove differs from the main run at 2^18")
    check(w18["chunks"] == [so.STREAM_CHUNK]
          and tr.padded_length // so.STREAM_CHUNK == 4,
          f"the forced run's stage-1 chunks: {w18['chunks']}")
    check(not w18["syncs"], f"the forced-stream run synchronized at "
          f"{collections.Counter(w18['syncs'])}")
    check(w18["fetches"] == tier_fetches and w18["k4"] == k4_launches,
          f"the forced-stream run: {w18['fetches']} fetches, K4 "
          f"{w18['k4']} (main {tier_fetches}, {k4_launches})")
    s1 = "stage1-spartan"
    k1_main = k1_by_stage(stage_launches)
    k1_stream = k1_by_stage(w18["launches"])
    print(f"[stream] 2^18 forced (4 chunks of {so.STREAM_CHUNK}), Dory: "
          f"proof bytes and FS tape == the main run's; {w18['fetches']} "
          f"fetches, 0 syncs; stage 1 {w18['stage_s'][s1]:.4f}s (main run, "
          f"materialized {stage_s[s1]:.4f}s), its own peak "
          f"{w18['s1_peak'] / 2**30:.3f} GiB (main "
          f"{main_peaks['s1'] / 2**30:.3f}), K1 {k1_stream[s1]} (main "
          f"{k1_main[s1]}); prove {w18['s']:.3f}s (main {t_prove:.3f}s), "
          f"peak {w18['peak'] / 2**30:.3f} GiB (main {peak / 2**30:.3f})",
          flush=True)
    del w18["proof"]
    t0 = time.perf_counter()
    tr20 = sha2_chain_trace(SHA2_CHAIN_2_20)
    t_trace20 = time.perf_counter() - t0
    check(tr20.length == SHA2_CHAIN_2_20_CYCLES
          and tr20.padded_length == 1 << 20,
          f"chain={SHA2_CHAIN_2_20}: {tr20.length} cycles, padded "
          f"{tr20.padded_length}")
    w20 = watched_prove(lambda: prove(tr20, device="cuda"), kernels, fused,
                        prover_mod, so)
    check(w20["chunks"] == [so.STREAM_CHUNK],
          f"2^20 did not stream stage 1: {w20['chunks']}")
    check(not w20["syncs"], f"the 2^20 run synchronized at "
          f"{collections.Counter(w20['syncs'])}")
    t0 = time.perf_counter()
    check(verify(w20["proof"], PublicIO.from_trace(tr20)) is True,
          "verify rejected the 2^20 proof")
    t_verify20 = time.perf_counter() - t0
    k1_20 = k1_by_stage(w20["launches"])
    print(f"[stream] 2^20: sha2-chain chain={SHA2_CHAIN_2_20}, "
          f"{tr20.length} cycles (traced in {t_trace20:.2f}s), prove("
          f"setup=None) {w20['s']:.3f}s = {tr20.length / w20['s']:.1f} "
          f"cycles/s, streamed unforced ({(1 << 20) // so.STREAM_CHUNK} "
          f"chunks), peak {w20['peak'] / 2**30:.3f} GiB, stage 1's own "
          f"{w20['s1_peak'] / 2**30:.3f} GiB; {w20['fetches']} fetches, "
          f"K4 {w20['k4']}, K1 {w20['k1']}, 0 syncs; verify "
          f"{t_verify20:.3f}s accepted", flush=True)
    for label, sec in w20["stage_s"].items():
        print(f"[stream] 2^20 {label}: {sec:.4f}s, K1 {k1_20.get(label, 0)}",
              flush=True)
    stream_entry = {
        "forced_2_18": {"stage1_s": w18["stage_s"][s1],
                        "main_stage1_s": stage_s[s1],
                        "stage1_peak_bytes": w18["s1_peak"],
                        "main_stage1_peak_bytes": main_peaks["s1"],
                        "prove_s": w18["s"], "peak_bytes": w18["peak"],
                        "k1_stage1": k1_stream[s1]},
        "unforced_2_20": {"cycles": tr20.length, "prove_s": w20["s"],
                          "verify_s": t_verify20, "stage_s": w20["stage_s"],
                          "k1_by_stage": k1_20, "peak_bytes": w20["peak"],
                          "stage1_peak_bytes": w20["s1_peak"],
                          "k4": w20["k4"], "fetches": w20["fetches"]}}
    del w20, tr20

    # ---- 6d. the cycle mesh: D = 1 over NCCL, D = 2 over gloo ------------
    print(f"[phase] 6d starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    mesh_entry = mesh_phase(tr, setup, proof, stage_launches, t_prove, peak,
                            dev)

    # ---- 7. card vs CPU on the fib trace ---------------------------------
    print(f"[phase] 7 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    fib_layout = MemoryLayout(**FIB_LAYOUT)
    fib = trace_program(FIB.format(output_start=fib_layout.output_start,
                                   termination=fib_layout.termination),
                        layout=fib_layout)
    on_card = prove(fib, device="cuda")
    on_cpu = prove(fib, device="cpu")
    check(serialize_proof(on_card) == serialize_proof(on_cpu)
          and on_card.fs_tape == on_cpu.fs_tape,
          "prove differs between cuda and cpu on the fib trace")
    check(verify(on_card, PublicIO.from_trace(fib)) is True,
          "verify rejected the fib proof")
    print(f"[card-vs-cpu] fib ({fib.length} cycles): identical proof bytes "
          f"({len(serialize_proof(on_card))} B); states "
          f"{[e['state'][:16] for e in on_card.fs_tape]}", flush=True)

    def card_vs_cpu(trace, what, setup=None, **flags):
        """The proof's bytes and FS tape on the card and on the CPU (zk
        with the same seed), and verify; returns the proof's size."""
        runs = {}
        for where in ("cuda", "cpu"):
            kw = dict(flags)
            if flags.get("zk"):
                kw["zk_rng"] = random.Random(42)
            runs[where] = prove(trace, setup=setup, device=where, **kw)
        blob = serialize_proof(runs["cuda"])
        check(blob == serialize_proof(runs["cpu"])
              and runs["cuda"].fs_tape == runs["cpu"].fs_tape,
              f"prove differs between cuda and cpu: {what}")
        check(verify(runs["cuda"], PublicIO.from_trace(trace), setup=setup)
              is True, f"verify rejected {what}")
        return len(blob)

    n_zk = card_vs_cpu(fib, "fib with zk", zk=True)
    image_guest = trace_program(IMAGE_GUEST.format(
        output_start=fib_layout.output_start,
        termination=fib_layout.termination), layout=fib_layout,
        min_padded=32)
    n_ci = card_vs_cpu(image_guest, "the image guest with the committed "
                       "image", committed_image=True)
    try:
        prove(fib, device="cuda", zk=True, committed_image=True)
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "zk=True with committed_image=True was not refused")
    print(f"[card-vs-cpu] fib with zk (Random(42)): identical proof bytes "
          f"({n_zk} B); image guest ({image_guest.length} cycles) with the "
          f"committed image: identical ({n_ci} B); both verified; zk with "
          "the committed image refused on the card", flush=True)
    # stage 6v's instance (d = 2: three factors on K2) on seeded chunks; the
    # claim is any value, since only card == CPU is checked here
    rng = np.random.default_rng(SEED)
    n_v = 1 << RA_VIRTUAL_LOG_T
    idx = rng.integers(0, 1 << RA_VIRTUAL_LOG_K, n_v)
    r_cyc = [int(x) for x in rng.integers(0, 1 << 62, RA_VIRTUAL_LOG_T)]
    r_addr = [int(x) for x in rng.integers(0, 1 << 62, RA_VIRTUAL_LOG_K)]
    chunks = chunk_streams(idx, RA_VIRTUAL_LOG_K)
    check(len(chunks) == 2, "the seeded ra-virtualization is not d = 2")
    runs = {}
    for where in ("cuda", "cpu"):
        inst = RaVirtual(chunks, RA_VIRTUAL_LOG_K, r_cyc, r_addr, 12345,
                         ("ram_ra", 0), device=where)
        acc, transcript = OpeningAccumulator(), Blake2bTranscript(b"6v")
        kernels.product_round.launches = 0
        polys, _ = BatchedSumcheck.prove([inst], acc, transcript)
        runs[where] = (polys, inst.final_openings, acc.openings,
                       transcript.state, kernels.product_round.launches)
    check(runs["cuda"][:4] == runs["cpu"][:4],
          "RaVirtual differs between cuda and cpu")
    check(runs["cuda"][4] == RA_VIRTUAL_LOG_T + 1,
          f"RaVirtual launched K2 {runs['cuda'][4]} times in "
          f"{RA_VIRTUAL_LOG_T} rounds")
    print(f"[card-vs-cpu] RaVirtual d=2 (log K {RA_VIRTUAL_LOG_K}, T = "
          f"2^{RA_VIRTUAL_LOG_T}): identical round polys, openings and "
          f"transcript; K2 launches on the card {runs['cuda'][4]}",
          flush=True)

    # ---- 7b. the alternative tiers, card vs host engine vs CPU -----------
    print(f"[phase] 7b starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    a19_entry = a19_phase([("fib", fib), ("sha2-chain chain=1",
                                          sha2_chain_trace(1))],
                          dev, kernels, fused)
    # ---- 7c. the CLI on the card -----------------------------------------
    print(f"[phase] 7c starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    cli_entry = cli_phase(prove, serialize_proof, trace_program,
                          MemoryLayout)

    # ---- 8. stage 7's largest group, card vs CPU --------------------------
    print(f"[phase] 8 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    # booleanity (K1) and Hamming weight (K2 cycle rounds) on seeded
    # streams; the claims are any values, since only card == CPU is checked
    streams = rng.integers(0, ONEHOT_K, (ONEHOT_M, 1 << ONEHOT_LOG_T))
    log_k = ONEHOT_K.bit_length() - 1
    r_cyc = [int(x) for x in rng.integers(2, 1 << 62, ONEHOT_LOG_T)]
    r_addr = [int(x) for x in rng.integers(2, 1 << 62, log_k)]
    for booleanity in (True, False):
        runs = {}
        for where in ("cuda", "cpu"):
            inst = GroupedOneHot(
                streams, ONEHOT_K, eq.evals(r_cyc, where),
                [r_addr if booleanity else None] * ONEHOT_M,
                list(range(ONEHOT_M)), 777, [f"m{i}" for i in
                                             range(ONEHOT_M)],
                booleanity=booleanity, opening_kind="t")
            acc, transcript = OpeningAccumulator(), Blake2bTranscript(b"s7")
            polys, _ = BatchedSumcheck.prove([inst], acc, transcript)
            runs[where] = (polys, inst.final_openings, acc.openings,
                           transcript.state)
        check(runs["cuda"] == runs["cpu"],
              f"GroupedOneHot (booleanity={booleanity}) differs between "
              "cuda and cpu")
        print(f"[card-vs-cpu] GroupedOneHot {'booleanity' if booleanity else 'Hamming'} "
              f"M = {ONEHOT_M}, K = {ONEHOT_K}, T = 2^{ONEHOT_LOG_T}: "
              "identical round polys, openings and transcript", flush=True)
    # the whole proof with a Dory setup, on a guest small enough for the CPU
    small = trace_program(DORY_SMALL.format(
        output_start=fib_layout.output_start,
        termination=fib_layout.termination), layout=fib_layout,
        min_padded=32)
    small_setup = DorySetup.generate(DORY_SMALL_VARS)
    on_card = prove(small, setup=small_setup, device="cuda")
    on_cpu = prove(small, setup=small_setup, device="cpu")
    check(serialize_proof(on_card) == serialize_proof(on_cpu)
          and on_card.fs_tape == on_cpu.fs_tape
          and on_card.fs_tape[-1]["stage"] == "stage8-openings",
          "prove with a Dory setup differs between cuda and cpu")
    check(verify(on_card, PublicIO.from_trace(small), setup=small_setup)
          is True, "verify rejected the small Dory proof")
    print(f"[card-vs-cpu] Dory guest ({small.length} cycles, setup nu="
          f"{small_setup.nu} sigma={small_setup.sigma}), Dory's G1 work on "
          f"K3 on the card against the native library on the CPU: "
          f"identical proof bytes ({len(serialize_proof(on_card))} B) and "
          f"FS tape ({len(on_card.fs_tape)} entries); verified", flush=True)
    n_zk = card_vs_cpu(small, "the Dory guest with zk", setup=small_setup,
                       zk=True)
    n_ci = card_vs_cpu(image_guest, "the image guest with Dory and the "
                       "committed image", setup=small_setup,
                       committed_image=True)
    print(f"[card-vs-cpu] with the 2^{DORY_SMALL_VARS} Dory setup: the Dory "
          f"guest with zk ({n_zk} B) and the image guest with the committed "
          f"image ({n_ci} B): identical bytes and FS tapes; verified",
          flush=True)

    # ---- 8b. K3, HyperKZG end to end, Dory's device one-hot tier ---------
    print(f"[phase] 8b starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    g1_entry = g1_kzg_phase(dev, gen, setup, small, onehot_positions,
                            card_vs_cpu)
    # K3's launches on the main path: the Dory prove's, by stage
    g1_entry = {**{k: g1_entry[k] for k in ("name", "route", "source",
                                            "replaces")},
                "launches": sum(k3_counts.values()),
                "launches_by_form": k3_counts, "launches_by_stage": dory_k3,
                **g1_entry, "spill_bytes": k3_spills,
                "stack_bytes": k3_stack,
                "dory_native_route_prove_s": t_native_prove,
                "dory_native_route_stage_s": {
                    k: nat_s[k] for k in ("stage0-commit",
                                          "stage8-openings")},
                "dory_k3_route_stage_s": {
                    k: stage_s[k] for k in ("stage0-commit",
                                            "stage8-openings")},
                "dory_k3_route_spans_s": spans,
                "dory_native_route_spans_s": nat_spans}

    # ---- 9. results -------------------------------------------------------
    print(f"[phase] 9 starts at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    # K2's headline: the main path's round (stage 1s: two factors, bind then
    # message) at 2^18; "ms" is its two kernels' device time
    k2 = k2_times[(2, "bind_message")]
    print(json.dumps({"kernels": [{
        "name": "mont_mul", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/mont_mul.cu",
        "replaces": "jolt_tpu/field/pallas_ops.py:45",
        "launches": launches, "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "form": head["form"],
        "shape": head["heaviest"]["key"],
        "forms": list(k1_forms.values()), "reference_shapes": k1_ref,
        "stage1_stream": stream_entry, "cli": cli_entry,
        "mesh": mesh_entry,
        "spill_bytes": k1_spills,
        "other_device_kernels": n_other}, {
        "name": "product_round", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/product_round.cu",
        "replaces": "jolt_tpu/field/pallas_ops.py:97",
        "launches": k2_launches, "max_abs_err": k2_err,
        "ms": k2["ms"], "wrapper_ms": k2["wrapper_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None, "shape": [[8, T]] * 2 + [[8, 1]],
        "order": "bind_message", "spill_bytes": k2_spills,
        "modes": [{"nf": nf, "order": order, **t}
                  for (nf, order), t in k2_times.items()],
        "message_bind_small": k2_small,
        "round_step_launches": k2_round_launches,
        "product_sumcheck_launches": k2_sumcheck_launches,
        "stage6v_instances": n6v, "ram_log_K": proof.ram_log_K,
        "bytecode_log_K": proof.bytecode_log_K,
        "launches_by_stage": {k: v["k2"] for k, v in
                              stage_launches.items()}}, g1_entry, {
        "name": "round_tail", "route": "cuda",
        "source": "jolt_tpu_torch/csrc/transcript.cu",
        "replaces": "jolt_tpu/transcript/device.py:103",
        "replaces_note": "no pallas_call: the jnp Blake2b transcript "
                         "(jolt_tpu/transcript/device.py:103-249) and the "
                         "round tail of jolt_tpu/sumcheck/scan.py:330-363",
        "launches": k4_launches, "max_abs_err": k4_err,
        "ms": k4_times["s1"]["ms"], "plain_ms": k4_times["s1"]["plain_ms"],
        "bound_ms": k4_times["s1"]["bound_ms"],
        "bound_by": k4_times["s1"]["bound_by"], "library_ms": None,
        "shape": "1 instance of degree 3, 3 compressed coefficients "
                 "(stage 1)",
        "wrapper_ms": k4_times["s1"]["wrapper_ms"], "shapes": k4_times,
        "by_part_cycles": k4_parts, "chain_floor": k4_floor,
        "sm_mhz": k4_mhz, "micro_cycles": k4_micro,
        "empty_launch": k4_launch, "stack_bytes": k4_stack,
        "launches_by_stage": k4_by_stage, "rounds_checked": k4_rounds,
        "stage_spans_s": tier_stage_spans,
        "top_bit_squeezes": k4_top, "fetches": tier_fetches,
        "spill_bytes": k4_spills,
        "tier_stage_s": {k: {"device_tier": stage_s[k],
                             "host_engine": nat_s[k]} for k in tier_stages},
        "tier_profiled": tier_busy, "device_tier_spans_s": fused_spans,
        "a19_tiers": a19_entry}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
