"""Import hygiene and the device rule of the torch port.

The port imports torch and numpy, never JAX and nothing of the JAX package
(whose `field/__init__.py` imports JAX): the machine with the card has no
JAX.  Its entry points run on the card unless the caller asks for the CPU.
"""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import jolt_tpu_torch

PKG = pathlib.Path(jolt_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import jolt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jolt_tpu_torch.__path__,
                                                "jolt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jolt_tpu"))
print(len(names), bad)
"""


def test_import_pulls_in_no_jax_and_no_jax_package():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 30
    assert bad == "[]"


PROOF_FORMAT_MODULES = ["jolt_tpu_torch.curve", "jolt_tpu_torch.pcs",
                        "jolt_tpu_torch.blindfold", "jolt_tpu_torch.proof_io"]

_IMPORT_EACH = """
import importlib, json, pkgutil, sys
seen = {}
for name in sys.argv[1:]:
    mod = importlib.import_module(name)
    for info in pkgutil.walk_packages(getattr(mod, "__path__", []),
                                      mod.__name__ + "."):
        importlib.import_module(info.name)
    seen[name] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "jolt_tpu"))
print(json.dumps(seen))
"""


@pytest.fixture(scope="module")
def proof_format_imports():
    """One interpreter imports each proof-format module (and its
    submodules) in turn; after each, the JAX and JAX-package modules
    loaded so far."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_EACH,
                          *PROOF_FORMAT_MODULES], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


@pytest.mark.parametrize("module", PROOF_FORMAT_MODULES)
def test_proof_format_modules_import_no_jax(proof_format_imports, module):
    """The copied host modules of the proof format (curve code, proof
    types, the codec) import with no JAX and nothing of the JAX package:
    their JAX package originals sit under a package whose `__init__`
    imports JAX."""
    assert proof_format_imports[module] == []


# the modules of the alternative tiers and the host entry points (ROADMAP
# A17, A19), each imported alone in one interpreter
ENTRY_AND_TIER_MODULES = [
    "jolt_tpu_torch.cli", "jolt_tpu_torch.sdk", "jolt_tpu_torch.eval",
    "jolt_tpu_torch.claims", "jolt_tpu_torch.tracer.trace_io",
    "jolt_tpu_torch.transcript.keccak", "jolt_tpu_torch.transcript.poseidon",
    "jolt_tpu_torch.relations.booleanity",
    "jolt_tpu_torch.relations.registers_rw",
    "jolt_tpu_torch.relations.ram", "jolt_tpu_torch.relations.spartan_outer"]


@pytest.fixture(scope="module")
def entry_and_tier_imports():
    res = subprocess.run([sys.executable, "-c", _IMPORT_EACH,
                          *ENTRY_AND_TIER_MODULES], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout)


@pytest.mark.parametrize("module", ENTRY_AND_TIER_MODULES)
def test_entry_and_tier_modules_import_no_jax(entry_and_tier_imports,
                                              module):
    """The CLI, the SDK, the eval harnesses, the claims layer, the trace
    files, the Keccak and Poseidon transcripts and the alternative
    relation tiers import with no JAX and nothing of the JAX package."""
    assert entry_and_tier_imports[module] == []


def _sources():
    """The package's sources; `_build/` holds build output, not source."""
    return [p for p in PKG.rglob("*")
            if p.suffix in (".py", ".cu", ".cuh", ".cpp", ".h")
            and "_build" not in p.relative_to(PKG).parts]


@pytest.mark.parametrize("pattern", [
    r"(?<![\w./])jolt_tpu/",              # a path under the JAX package
    r"(?<![\w./])native/",                # the JAX package's native dir
    r"^\s*(import|from)\s+jax",           # an import of JAX
    r"^\s*(import|from)\s+jolt_tpu(\.|\s)",   # of the JAX package
])
def test_sources_name_nothing_of_the_jax_package(pattern):
    hits = []
    for path in _sources():
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(pattern, line):
                hits.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


# ---- host <-> card copies ------------------------------------------------

# modules off the prove path, whose copies no counter sees
COPIES_OFF_PATH = {
    "verifier": "the verifier: host work on the proof",
    "eval": "the eval harnesses drive `prove`; their own reads are "
            "results",
    "tracer": "the tracer runs before `prove` and makes host arrays",
    "riscv": "the emulator and assembler: host work",
    "interop.py": "conversions to and from the JAX package's limbs, for "
                  "the tests",
    "sdk.py": "the SDK's analysis of a trace (host numpy)",
    "cli.py": "the command line",
    "bench.py": "a timing script around `prove`",
    "profile_prefix.py": "a profiling script around `prove_prefix`",
    "workload.py": "workload builders and bounds for the chip scripts",
    "parallel/spawn.py": "the ranks' launcher and collective probes of "
                         "the tests and chip checks",
}
# (module, function): the copy-like calls on the prove path that are not
# copies between host and card, each with the reason
COPIES_EXEMPT = {
    ("field/ops.py", "host"): "the counted device-to-host helper",
    ("field/ops.py", "upload"): "the counted host-to-device helper",
    ("field/fq.py", "_flat_ints"): "plain Fq's int path: CPU tensors only",
    ("field/fq.py", "_from_ints"): "plain Fq's int path: CPU tensors only",
    ("field/kernels.py", "_p_words"): "a plain version's constant, on the "
                                      "CPU tensors' device",
    ("field/kernels.py", "_p16"): "a plain version's constant, on the CPU "
                                  "tensors' device",
    ("field/kernels.py", "_r_tensor"): "a challenge already on a card, "
                                       "moved to the factors' card",
    ("field/params.py", "limbs_to_int"): "numpy limbs (host)",
    ("pcs/dory.py", "onehot_rows"): "numpy row indices (host)",
    ("pcs/dory.py", "_sv_python"): "numpy positions (host, the Python "
                                   "tier)",
    ("pcs/scheme.py", "open_rlc"): "numpy positions (host)",
    ("pcs/hyperkzg.py", "commit_positions"): "numpy positions (host, the "
                                             "CPU route)",
    ("pcs/hyperkzg.py", "_powers_setup"): "`KZGSetup.to`, whose copies "
                                          "are `ops.upload`'s",
    ("transcript/device.py", "_words64"): "K4's plain version: the CPU "
                                          "only",
    ("transcript/device.py", "idx"): "K4's plain version's constants: the "
                                     "CPU only",
    ("transcript/device.py", "round_tail_plain"): "K4's plain version: the "
                                                  "CPU only",
    ("transcript/device.py", "_stage_record"): "numpy label words into "
                                               "K4's launch record",
    ("witness/*", "*"): "witness extraction: numpy arrays of the trace "
                        "(host)",
}
_D2H = ("cpu", "item", "tolist", "numpy")


def _copy_calls(node, fn="<module>"):
    """(line, function, call) for each call that may copy between host and
    card: `.cpu()`, `.item()`, `.tolist()`, `.numpy()`, `.cuda()`,
    `torch.from_numpy(...)`, `torch.tensor` / `torch.as_tensor` with a
    device, and `.to(...)` with a device argument."""
    import ast
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        fn = node.name
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        f, kw = node.func, {k.arg for k in node.keywords}

        def devish(a):
            name = getattr(a, "id", None) or getattr(a, "attr", "")
            return "dev" in name
        torch_call = isinstance(f.value, ast.Name) and f.value.id == "torch"
        if (f.attr in _D2H + ("cuda",) and not node.args
                or torch_call and f.attr == "from_numpy"
                or torch_call and f.attr in ("tensor", "as_tensor")
                and "device" in kw
                or f.attr == "to" and (node.args and devish(node.args[0])
                                       or "device" in kw)):
            yield node.lineno, fn, f.attr
    for c in ast.iter_child_nodes(node):
        yield from _copy_calls(c, fn)


def test_copies_between_host_and_card_go_through_the_counted_helpers():
    """On the prove path every copy between host and card is
    `ops.host` (counts `d2h`, `d2h_bytes`) or `ops.upload` (`h2d`,
    `h2d_bytes`); the exceptions are in COPIES_EXEMPT with their
    reasons."""
    import ast
    hits, used = [], set()
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        if "_build" in rel or any(rel == m or rel.startswith(m + "/")
                                  for m in COPIES_OFF_PATH):
            continue
        tree = ast.parse(path.read_text())
        for line, fn, what in _copy_calls(tree):
            key = next((k for k in ((rel, fn),
                                    (rel.split("/")[0] + "/*", "*"))
                        if k in COPIES_EXEMPT), None)
            if key is None:
                hits.append(f"{rel}:{line} {fn}: .{what}(...)")
            used.add(key)
    assert not hits, "\n".join(hits)
    assert used - {None} == set(COPIES_EXEMPT), \
        f"exemptions that match nothing: {set(COPIES_EXEMPT) - used}"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.tracer import trace_program
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    trace = trace_program(f"""
        li t1, {layout.termination}
        li t2, 1
        sd t2, 0(t1)
    """, layout=layout)
    with pytest.raises(RuntimeError, match="CUDA"):
        jolt_tpu_torch.prove_prefix(trace)
    with pytest.raises(RuntimeError, match="CUDA"):
        jolt_tpu_torch.prove(trace)
    # a rank's prove under the cycle mesh, as `spawn.run_ranks` runs it
    from jolt_tpu_torch.parallel.spawn import prove_rank
    with pytest.raises(RuntimeError, match="CUDA"):
        prove_rank(0, 1, trace)


def test_kernel_wrapper_refuses_mixed_devices():
    from jolt_tpu_torch.field import kernels
    a = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.mont_mul(a, a.to("meta"))


def test_pairing_library_builds_from_the_port_sources():
    """The Dory pairing library is built from `jolt_tpu_torch/csrc/` into
    the gitignored `jolt_tpu_torch/_build/`, never from or into the JAX
    package's native directory, and the loaded library is that file."""
    from jolt_tpu_torch.curve import native_pairing
    src = pathlib.Path(native_pairing.SRC).resolve()
    lib = pathlib.Path(native_pairing.library_path()).resolve()
    assert src == PKG / "csrc" / "pairing.cpp"
    assert lib.parent == PKG / "_build"
    assert native_pairing.load() is not None
    assert pathlib.Path(native_pairing.load()._name).resolve() == lib
    assert lib.is_file()


_LOAD_SETUP = """
import sys, time
from jolt_tpu_torch.pcs.dory import DorySetup
t0 = time.perf_counter()
setup = DorySetup.generate(6, cache_dir=sys.argv[1])
took = time.perf_counter() - t0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jolt_tpu"))
print(type(setup).__module__, setup.nu, setup.sigma, took < 0.5, bad)
"""


def test_cached_setup_loads_without_jax(tmp_path):
    """A Dory setup cached by the port loads in a fresh interpreter (from
    the cache, not rebuilt) and pulls in no JAX and nothing of the JAX
    package."""
    from jolt_tpu_torch.pcs.dory import DorySetup
    DorySetup.generate(6, cache_dir=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", _LOAD_SETUP, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["jolt_tpu_torch.pcs.dory", "3", "3",
                                  "True", "[]"]
