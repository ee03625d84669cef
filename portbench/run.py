"""The benchmark's command: one run of one cell on the machine it starts on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the set-up's split and the check's lines on standard error, then
the numbers compared beside their limits as its last lines there, and as
the last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, with --trace 1 `breakdown`,
and last `checks` (each number compared with its limit).  It exits 3
without a result when the card is missing, and 4 when JAX or the JAX
package was loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness
    from .spec import load_cell

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = load_cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[run] needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"[run] loaded in this process: {', '.join(found)}")
        return 4
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": chips, **out["device"]}
    out["checks"] = out.pop("checks")        # the last key of the line
    log(f"[run] {harness.process_age_s():.3f} s since the process "
        "started")
    for name, c in out["checks"].items():
        log(f"[limit] {name} {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
