"""The port's device tier of a batched sumcheck stage
(`jolt_tpu_torch/sumcheck/fused.py`), on the CPU: its round loop runs on
the plain versions of K4 (the round tail) and K1/K2 when a stage's slots
are forced to the device tier.

In the style of the JAX package's `tests/test_fused_prove.py`: a stage of
three product instances of degrees 1, 2 and 3 with 3, 5 and 4 rounds (so
two are inactive in the first rounds, and the compressed length changes
with the round) gives the host engine's round polynomials, challenges,
openings and transcript state; a fetched coefficient tampered with makes
the host's replay raise, naming the round; and the tier is chosen in one
place (`device_tier`).
"""

import numpy as np
import pytest
import torch

from jolt_tpu_torch.field import ops
from jolt_tpu_torch.sumcheck import fused
from jolt_tpu_torch.sumcheck.engine import (BatchedSumcheck,
                                            OpeningAccumulator,
                                            SumcheckInstance)
from jolt_tpu_torch.sumcheck.fused import (FusedInstance, TranscriptDivergence,
                                           device_tier, prove_fused)
from jolt_tpu_torch.sumcheck.product import ProductSumcheck
from jolt_tpu_torch.transcript import Blake2bTranscript
from jolt_tpu_torch.utils import profiling

torch.set_num_threads(1)

CPU = "cpu"


class HostOnly(SumcheckInstance):
    """A product sumcheck that is no `FusedInstance`: the host engine's
    interface alone, delegated."""

    def __init__(self, polys):
        self.inner = ProductSumcheck(polys)
        self.device = self.inner.device
        self.degree = self.inner.degree

    @property
    def num_rounds(self):
        return self.inner.num_rounds

    def input_claim(self, accumulator):
        return self.inner.input_claim(accumulator)

    def message_evals_dev(self, round):
        return self.inner.message_evals_dev(round)

    def ingest_challenge(self, r, round):
        self.inner.ingest_challenge(r, round)

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError


def _instances(force_device=True):
    """Degrees 1, 2, 3 (1, 2, 3 factors) over 3, 5 and 4 variables."""
    rng = np.random.default_rng(11)
    out = []
    for nf, log_t in ((1, 3), (2, 5), (3, 4)):
        polys = [ops.pack_ints([int(v) for v in rng.integers(
            0, 1 << 62, 1 << log_t, dtype=np.int64)], CPU)
            for _ in range(nf)]
        inst = ProductSumcheck(polys)
        inst.force_device = force_device
        out.append(inst)
    return out


def _run(prover, instances):
    acc = OpeningAccumulator()
    tr = Blake2bTranscript(b"fused-test")
    polys, r = prover(instances, acc, tr)
    return polys, r, tr.state, tr.n_rounds, {
        k[2]: v for k, v in acc.openings.items()}, [
            i.final_claims for i in instances]


def test_device_tier_stage_matches_host_engine():
    with profiling.recording() as prof:
        got = _run(prove_fused, _instances())
    assert prof.tally("d2h", within="fused.fetch") == 1
    want = _run(BatchedSumcheck.prove, _instances(False))
    assert [len(p) for p in got[0]] == [2, 3, 3, 3, 3]   # per round
    assert got[:4] == want[:4]
    assert got[5] == want[5]
    # openings are keyed by instance identity; compare them in order
    assert list(got[4].values()) == list(want[4].values())


@pytest.mark.parametrize("rnd", [0, 2, 4])
def test_tampered_fetch_raises_naming_the_round(monkeypatch, rnd):
    real = fused._fetch

    def tampered(buffers):
        host = real(buffers).copy()
        n, width = 3, 3
        host[9 + 16 * n + rnd * width * 8] ^= 1     # coefficient 0, word 0
        return host
    monkeypatch.setattr(fused, "_fetch", tampered)
    with pytest.raises(TranscriptDivergence, match=f"at round {rnd} of 5"):
        _run(prove_fused, _instances())


def test_tier_choice():
    insts = _instances()
    assert device_tier(insts)
    assert not device_tier(_instances(False))      # CPU tensors, not forced
    insts[1].force_host = True                     # a host-forced slot
    assert not device_tier(insts)
    plain = HostOnly(_instances()[0].S.unbind(1))
    plain.force_device = True                      # not a FusedInstance
    assert not device_tier([plain])
    rng = np.random.default_rng(12)
    wide = ProductSumcheck([ops.pack_ints([int(v) for v in rng.integers(
        0, 1 << 62, 8, dtype=np.int64)], CPU) for _ in range(4)])
    wide.force_device = True                       # degree 4, above K4's 3
    assert isinstance(wide, FusedInstance) and not device_tier([wide])
