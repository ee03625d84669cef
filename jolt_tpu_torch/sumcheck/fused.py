"""The device tier of a batched sumcheck stage: the round loop with the
Fiat-Shamir transcript on the card.

Torch counterpart of the JAX package's `sumcheck/fused.py` and of the
stage loop of its `sumcheck/scan.py`.  The host engine (`engine.py`) copies
every round's messages to the host, interpolates, batches, absorbs and
draws the challenge there: one blocking device-to-host copy a round.  Here
a round is three things enqueued on the card's stream, and the host never
waits for it inside the loop:

  1. each active instance's message evals (`message_evals_dev`);
  2. one round tail (`transcript.device.round_tail`: K4 on the card, its
     plain version on the CPU), which recovers the coefficients, batches,
     absorbs, squeezes the challenge into the stage's device buffers and
     updates the claims;
  3. each active instance's bind at that device challenge (`fused_bind`).

After the last round each instance enqueues its final tensors
(`fused_finals`: the fully bound values its openings are read from), and
ONE device-to-host fetch (`_fetch`) returns every round's compressed
coefficients, the challenges, the final transcript state and those
finals: the JAX package's `fused_finals` / `fused_store`.  The host then
replays its own transcript over the fetched coefficients, as the JAX
package's scan tier does: every challenge it draws must equal the
device's, and the final state too, or `TranscriptDivergence` names the
round.  So the proof's bytes are the host engine's by construction.  Each
instance takes its fetched finals (`fused_store`, in place of the
engine's `finalize`, which copies them itself), then `cache_openings` and
`flush_to_transcript` run as in the engine.  Spans (`utils/profiling.py`):
`fused.rounds` from the input claims through the enqueued rounds,
`fused.fetch` (its one `d2h`), `fused.replay`, then `stage.openings`.

PyTorch runs eagerly, so the stage is a Python loop over rounds; the JAX
scan tier's pair order, shrink plans and segments exist only to keep XLA's
compile small (one compiled round body per segment) and are not ported.
Nor is its purity contract (`consts` / `state` pytrees): an instance keeps
its own tensors and updates them in place.

Tier choice, in one place (`device_tier`), as the JAX package's
`_supports_scan`: a stage takes this tier when every instance is a
`FusedInstance` of degree 3 or less, the stage has at most K4's 64
instances (`kernels.K4_MAX_INSTANCES`), no instance was forced to the host
tier through the backend seam (`kernels/registry.py`), and the stage's
tensors are on CUDA or its slots were forced to the device tier (how the
CPU tests run this loop on the plain versions), and no cycle mesh is
active (`parallel/mesh.py`; the JAX package's scan tier is off under a
mesh too).  Otherwise the stage takes the host engine.  The rule reads
only the instances, before any launch; on the device tier a kernel that
fails to build or launch raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import kernels, ops
from ..field.params import FR
from ..parallel.mesh import active_mesh
from ..transcript import Blake2bTranscript
from ..transcript import device as dt
from ..utils import profiling
from .engine import BatchedSumcheck, OpeningAccumulator, SumcheckInstance

P = FR.modulus

class TranscriptDivergence(RuntimeError):
    """The host's replay of a device-tier stage drew another challenge, or
    reached another state, than the device transcript."""


class FusedInstance(SumcheckInstance):
    """A sumcheck instance the device tier can run: `degree` (1-3) and
    `device` attributes, `message_evals_dev` that never returns None,
    `fused_bind`, and its finals (`fused_finals`, `fused_store`).  None of
    them waits for the card: no copy to or from the host, no value read
    back, no mask indexing."""

    degree: int
    device: torch.device

    def fused_finals(self) -> List[torch.Tensor]:
        """After the last bind: the device tensors (8, ...) whose values
        `fused_store` takes, enqueued and not read."""
        raise NotImplementedError

    def fused_store(self, values: List[int]) -> None:
        """Take the finals' values (canonical ints, each tensor's elements
        in order, tensor after tensor) for `cache_openings`."""
        raise NotImplementedError

    def finalize(self) -> None:
        """The host engine's end: the finals in one copy of their own."""
        self.fused_store(ops.unpack_ints(_flat(self.fused_finals())))

    def fused_bind(self, r_dev: torch.Tensor, round: int) -> None:
        """Bind the round's variable at the challenge r_dev, a device scalar
        (8, 1) of Montgomery limbs that the round tail wrote, without the
        value on the host.  By default `ingest_challenge`, for an instance
        whose binds take a device scalar as they take an int (K1's bind,
        K2's `ProductRounds`)."""
        self.ingest_challenge(r_dev, round)


def device_tier(instances: Sequence[SumcheckInstance]) -> bool:
    """Whether a stage of these instances takes the device tier (module
    docstring).  Never under a cycle mesh (`parallel/mesh.py`), even when
    forced: every stage then takes the host engine, as in the JAX
    package."""
    if active_mesh() is not None:
        return False
    if not all(isinstance(i, FusedInstance) and 1 <= i.degree <= 3
               for i in instances):
        return False
    if len(instances) > kernels.K4_MAX_INSTANCES:
        return False
    if any(getattr(i, "force_host", False) for i in instances):
        return False
    return all(i.device.type == "cuda" or getattr(i, "force_device", False)
               for i in instances)


def _device_rounds(instances, offs, active, n_c, bufs: dt.StageBuffers
                   ) -> Tuple[torch.Tensor, List[int]]:
    """The round loop: per round the active instances' messages, the round
    tail into `bufs`, and their binds at its device challenge; then the
    instances' finals as one (8, n) tensor and each instance's count of
    them.  Enqueued on the card's stream, it never waits for the card."""
    degrees = [inst.degree for inst in instances]
    for rnd, row in enumerate(active):
        evals: List[Optional[torch.Tensor]] = [
            inst.message_evals_dev(rnd - off) if a else None
            for inst, off, a in zip(instances, offs, row)]
        dt.round_tail(evals, degrees, bufs, rnd, n_c[rnd])
        r_dev = bufs.challenge(rnd)
        for inst, off, a in zip(instances, offs, row):
            if a:
                inst.fused_bind(r_dev, rnd - off)
    finals = [inst.fused_finals() for inst in instances]
    counts = [sum(f[0].numel() for f in fs) for fs in finals]
    return _flat([f for fs in finals for f in fs]), counts


def _flat(finals: Sequence[torch.Tensor]) -> torch.Tensor:
    """Final tensors (8, ...) as one (8, n) tensor, elements in order."""
    return torch.cat([f.reshape(f.shape[0], -1) for f in finals], dim=1)


def _fetch(buffers: torch.Tensor) -> np.ndarray:
    """The stage's one device-to-host copy (`ops.host`: the `d2h` count of
    the span `fused.fetch`)."""
    return ops.host(buffers)


def _unpack(rows: np.ndarray) -> List[int]:
    """(n, 8) Montgomery words -> n canonical ints."""
    return ops.np_unpack_ints(np.ascontiguousarray(rows.T))


def prove_fused(instances: Sequence[SumcheckInstance],
                accumulator: OpeningAccumulator,
                transcript: Blake2bTranscript,
                ) -> Tuple[List[List[int]], List[int]]:
    """`BatchedSumcheck.prove` for a stage: the device tier when
    `device_tier` says so, else the host engine; the same polynomials,
    challenges, openings and transcript either way."""
    if not device_tier(instances):
        return BatchedSumcheck.prove(instances, accumulator, transcript)
    devices = {i.device for i in instances}
    if len(devices) != 1:
        raise ValueError(f"a stage's instances on {sorted(map(str, devices))}")
    prof = profiling.active()
    max_rounds = max(i.num_rounds for i in instances)
    with prof.span("fused.rounds"):
        for inst in instances:
            transcript.append_scalar(b"sumcheck_claim",
                                     inst.input_claim(accumulator))
        coeffs = transcript.challenge_vector(len(instances))
        claims = [(inst.input_claim(accumulator)
                   << (max_rounds - inst.num_rounds)) % P
                  for inst in instances]
        offs = [inst.round_offset(max_rounds) for inst in instances]
        degrees = [inst.degree for inst in instances]
        active = [[off <= rnd < off + inst.num_rounds
                   for inst, off in zip(instances, offs)]
                  for rnd in range(max_rounds)]
        n_c = [dt.compressed_len(row, degrees) for row in active]
        bufs = dt.stage_buffers(devices.pop(), transcript.state,
                                transcript.n_rounds, claims, coeffs,
                                max_rounds, max(degrees))
        flat, counts = _device_rounds(instances, offs, active, n_c, bufs)
    with prof.span("fused.fetch"):
        host = _fetch(torch.cat([bufs.all, flat.reshape(-1)]))
    n_all = bufs.all.numel()

    with prof.span("fused.replay"):
        final_ints = ops.np_unpack_ints(host[n_all:].reshape(8, -1))
        host = host[:n_all]
        sizes = [t.numel() for t in (bufs.state, bufs.claims, bufs.coeffs,
                                     bufs.comp)]
        at = np.cumsum([0] + sizes)
        state = host[:9].view(np.uint32)
        comp = host[at[3]:at[4]].view(np.uint32).reshape(bufs.comp.shape)
        r_dev_ints = _unpack(host[at[4]:].view(np.uint32).reshape(-1, 8))
        polys: List[List[int]] = []
        r_sumcheck: List[int] = []
        for rnd in range(max_rounds):
            compressed = _unpack(comp[rnd, :n_c[rnd]])
            transcript.append_scalars(b"sumcheck_poly", compressed)
            r_j = transcript.challenge_scalar_optimized()
            if r_j != r_dev_ints[rnd]:
                raise TranscriptDivergence(
                    f"device transcript diverged at round {rnd} of "
                    f"{max_rounds}: the host drew {r_j}, the device "
                    f"{r_dev_ints[rnd]}")
            polys.append(compressed)
            r_sumcheck.append(r_j)
        if (dt.words_to_state(state[:8]) != transcript.state
                or int(state[8]) != transcript.n_rounds):
            raise TranscriptDivergence(
                f"device transcript diverged at round {max_rounds - 1} of "
                f"{max_rounds}: final state or n_rounds differs from the "
                "host's")

    with prof.span("stage.openings"):
        at = np.cumsum([0] + counts)
        for k, inst in enumerate(instances):
            inst.fused_store(final_ints[at[k]:at[k + 1]])
        for inst, off in zip(instances, offs):
            inst.cache_openings(accumulator,
                                r_sumcheck[off:off + inst.num_rounds])
        accumulator.flush_to_transcript(transcript)
    return polys, r_sumcheck
