"""Which transport carries two ranks of the cycle mesh on one card: each
collective DTensor issues, over gloo on CUDA tensors, through
`torch.distributed._functional_collectives` (funcol, the path DTensor
takes) and through `torch.distributed` (c10d), each on a fresh pair of
ranks (`spawn.probe_ranks`: a backend that kills its process still names
the collective); and whether NCCL takes two ranks on one card.  On a
machine with one NVIDIA GPU:

    python3 experiments/one_card_ranks.py

It prints the card's name and power limit, the torch and NCCL versions,
and one line a (backend, path, collective): "ok", a wrong result, the
error, or the signal that ended a rank.
"""

from __future__ import annotations

import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("one_card_ranks: no CUDA device")
    from jolt_tpu_torch.parallel.spawn import probe_ranks
    from jolt_tpu_torch.workload import card_line
    print(card_line(), f"torch {torch.__version__}",
          f"nccl {'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    for backend, path in (("gloo", "funcol"), ("gloo", "c10d"),
                          ("nccl", "c10d")):
        for name, res in probe_ranks(2, backend, "cuda", path).items():
            print(f"{backend} {path} {name}: {res}", flush=True)


if __name__ == "__main__":
    main()
