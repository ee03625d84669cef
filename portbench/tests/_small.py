"""A small CPU cell for the tests: the fibonacci guest with n in
[20, 30), padded to 2^8, under a Dory setup cut to nu = 4 so the
reference's Python-int setup takes seconds."""

from portbench import spec
from portbench.harness import run_cell
from portbench.reference import check

check.WORKERS = 2           # several test workers share the CPU

TRAFFIC = {"guest": "fibonacci", "params": {},
           "memory_layout": {"max_input_size": 64, "max_output_size": 64},
           "input": {"kind": "u64", "lo": 20, "hi": 30},
           "traces": 2, "padded_log2": 8}
SHA2_TRAFFIC = {**TRAFFIC, "guest": "sha2-chain", "params": {"chain": 1},
                "input": {"kind": "bytes", "length": 32},
                "expect": {"kind": "sha256_chain", "links": 1},
                "padded_log2": 12}


def small_cell(zk=False, traffic=TRAFFIC, per_layer=False):
    config = {"name": "small", "trace_log2": traffic["padded_log2"],
              "dory_max_nu": 4, "zk": zk}
    readers, layer = {}, []
    if per_layer:
        for name in ("witness_s", "dory_commit_s", "dory_open_s",
                     "sumcheck_s", "sumcheck_launches", "blindfold_s",
                     "k1_roofline_pct", "device_idle_pct"):
            readers[name] = spec.load_reader(name)
            layer.append({"name": name})
    e2e = [{"name": "prove_cycles_per_s"}, {"name": "peak_device_gib"},
           {"name": "setup_s"}]
    return spec.Cell("small", {"chips": 1, "config": "small",
                               "traffic": "small"},
                     config, traffic,
                     {"warmup_proves": 1, "checked_proofs": 1},
                     e2e, layer, readers)


def run_small(tmp_path, seed=5, prove_fn=None, **kw):
    import torch
    torch.set_num_threads(2)        # several test workers share the CPU
    cache = tmp_path.parent / "portbench-cache"
    return run_cell(small_cell(**kw), seed, 0.0, kw.get("per_layer", False),
                    device="cpu", prove_fn=prove_fn, log=print,
                    cache_dir=str(cache))
