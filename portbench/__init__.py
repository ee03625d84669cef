"""The benchmark of `jolt_tpu_torch`: whole proofs on one NVIDIA H100.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`BENCHMARK.json` at the checkout's root names the cells; each cell names
a configuration (`configs/<name>.json`), a traffic mix
(`traffic/<name>.json`, read by the one generator in `traffic.py`) and its
own settings (`cells/<name>.json`); each per-layer metric is a reader in
`metrics/<name>.py`.  The reference that decides `correct` is
`reference/`: a frozen copy of the port's verifier, which imports nothing
of the port but is not independent of it.
"""
