"""The port's public names against the JAX package's, read from source.

An `ast` walk of `jolt_tpu/` and `jolt_tpu_torch/` (neither package is
imported): every public module-level function and class of a JAX module,
and every public method of such a class, has a counterpart of the same
name in the port's module of the same path -- a module-level name the
port binds there (a def, a class, an assignment or an import), or a
method the port's class defines or inherits from its port bases.  The
only exceptions are `EXCLUDED`, each with its reason; an entry that no
longer matches a missing name fails too, so the table stays exact.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from functools import lru_cache
from typing import Dict, List, Optional, Set, Tuple

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX, PORT = "jolt_tpu", "jolt_tpu_torch"

# What the port leaves out on purpose: a module path ("sumcheck/scan.py"),
# a name ("field/ops.py:reduce_lazy_cols") or a method
# ("relations/*.py:*.scan_*"); fnmatch patterns.  ROADMAP.md's "Not to
# port" list points here.
EXCLUDED: Dict[str, str] = {
    "sumcheck/scan.py": "the scan tier: sumcheck/fused.py's device tier "
                        "and K4 compute what it computes; its pair order, "
                        "shrink plans and segments keep XLA's compiles small",
    "relations/*.py:*.scan_*": "the scan tier's per-relation hooks "
                               "(sumcheck/scan.py); the port's relations "
                               "take the fused_* hooks of sumcheck/fused.py",
    **{f"*.py:*.fused_{hook}": "the JAX fused tier's pure contract (a "
       "consts and a state pytree, a compile key); the port's instances "
       "keep their tensors, update them in place and give their messages "
       "through message_evals_dev (sumcheck/fused.py)"
       for hook in ("consts", "state", "message", "key")},
    "relations/grouped_onehot.py:GroupedOneHot.masks": "the JAX host "
        "engine's per-cycle address-bit masks; the port folds the cycles "
        "into the K addresses once and needs none",
    "sumcheck/stepped.py": "the JAX package's stepped loop of s8, an XLA "
                           "compile-time work-around; the device tier "
                           "carries s8",
    "field/pallas_ops.py": "the Pallas kernels: K1 (csrc/mont_mul.cu) and "
                           "K2 (csrc/product_round.cu) replace them",
    "field/limb_algebra.py": "13-bit limb algebra for the TPU's missing "
                             "widening multiply; csrc/fr.cuh and K1's plain "
                             "versions (field/kernels.py) replace it",
    "field/ops.py:reduce_lazy_cols": "lazy uint32 sums of 13-bit limbs; the "
                                     "port sums exact int64 limb planes and "
                                     "reduces them with K1's reduce form "
                                     "(ops.reduce_cols)",
    "relations/spartan_outer.py:pack_u64_columns": "the JAX package's u32 "
                                                   "device columns; the port "
                                                   "lifts the inputs in one "
                                                   "step (pack_input_columns)",
    "utils/env.py": "an XLA:CPU mmap guard (ensure_map_count); torch needs "
                    "none",
}


@lru_cache(maxsize=None)
def _module(pkg: str, rel: str) -> Optional[ast.Module]:
    path = os.path.join(ROOT, pkg, rel)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ast.parse(f.read(), path)


def _jax_modules() -> List[str]:
    base = os.path.join(ROOT, JAX)
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs
                  if f.endswith(".py"))


def _top(tree: ast.Module) -> List[ast.stmt]:
    """Module-level statements, those under a module-level if / try too."""
    out, todo = [], list(tree.body)
    while todo:
        n = todo.pop(0)
        if isinstance(n, (ast.If, ast.Try)):
            todo[:0] = (n.body + n.orelse
                        + [s for h in getattr(n, "handlers", [])
                           for s in h.body]
                        + getattr(n, "finalbody", []))
        else:
            out.append(n)
    return out


def _defs(body) -> Set[str]:
    """Names a body binds: defs, classes and assignment targets."""
    names = set()
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names |= {t.id for t in n.targets if isinstance(t, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def _resolve(rel: str, level: int, module: Optional[str]) -> Optional[str]:
    """The module path (a file under the package) of a relative import in
    module `rel`; None for an absolute import or a missing file."""
    if level == 0:
        return None
    parts = os.path.dirname(rel).split(os.sep) if os.path.dirname(rel) else []
    parts = parts[:len(parts) - (level - 1)]
    if module:
        parts += module.split(".")
    for cand in (os.path.join(*parts) + ".py" if parts else None,
                 os.path.join(*parts, "__init__.py") if parts
                 else "__init__.py"):
        if cand and os.path.exists(os.path.join(ROOT, PORT, cand)):
            return cand
    return None


def _imports(rel: str) -> Dict[str, Tuple[Optional[str], Optional[str]]]:
    """Port module `rel`'s relative imports: local name -> (module path,
    name there), the name None where the import binds a module."""
    out = {}
    for n in _top(_module(PORT, rel)):
        if isinstance(n, ast.ImportFrom):
            src = _resolve(rel, n.level, n.module)
            for a in n.names:
                sub = _resolve(rel, n.level,
                               ".".join(filter(None, [n.module, a.name])))
                if sub:
                    out[a.asname or a.name] = (sub, None)
                elif src:
                    out[a.asname or a.name] = (src, a.name)
    return out


def _port_class(rel: str, name: str, depth: int = 0):
    """(module path, ClassDef) of the port class `name` as module `rel`
    sees it, following re-exports; None for a class outside the port."""
    tree = _module(PORT, rel) if depth < 8 else None
    if tree is None:
        return None
    for n in _top(tree):
        if isinstance(n, ast.ClassDef) and n.name == name:
            return rel, n
    src = _imports(rel).get(name)
    if src and src[1]:
        return _port_class(src[0], src[1], depth + 1)
    return None


def _base(rel: str, expr: ast.expr):
    if isinstance(expr, ast.Name):
        return _port_class(rel, expr.id)
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        src = _imports(rel).get(expr.value.id)
        if src and src[1] is None:
            return _port_class(src[0], expr.attr)
    return None


def _members(rel: str, cls: ast.ClassDef, depth: int = 0) -> Set[str]:
    """What a port class defines or inherits from its port bases."""
    names = _defs(cls.body)
    for b in cls.bases:
        found = _base(rel, b) if depth < 16 else None
        if found:
            names |= _members(*found, depth + 1)
    return names


def _port_names(rel: str) -> Set[str]:
    names = _defs(_top(_module(PORT, rel)))
    for n in _top(_module(PORT, rel)):
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return names


def _excluded(key: str) -> Optional[str]:
    for pat in EXCLUDED:
        if fnmatch.fnmatchcase(key, pat):
            return pat
    return None


def missing(rel: str) -> List[Tuple[str, Optional[str]]]:
    """The JAX module's public names the port lacks, each as (key, the
    exclusion that covers it or None); key "path", "path:name" or
    "path:Class.method"."""
    if _module(PORT, rel) is None:
        return [(rel, _excluded(rel))]
    out = []
    port = _port_names(rel)
    for n in _top(_module(JAX, rel)):
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) or n.name.startswith("_"):
            continue
        key = f"{rel}:{n.name}"
        if n.name not in port:
            out.append((key, _excluded(key)))
            continue
        if not isinstance(n, ast.ClassDef):
            continue
        found = _port_class(rel, n.name)
        have = _members(*found) if found else None
        for m in n.body:
            if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_")
                    and have is not None and m.name not in have):
                mkey = f"{key}.{m.name}"
                out.append((mkey, _excluded(mkey)))
    return out


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_has_the_jax_module_surface(rel):
    lacking = [k for k, why in missing(rel) if why is None]
    assert not lacking, f"the port lacks {lacking}"


def test_every_exclusion_is_used_and_has_a_reason():
    used = {why for rel in _jax_modules() for _, why in missing(rel) if why}
    assert set(EXCLUDED) == used, f"unused: {set(EXCLUDED) - used}"
    assert all(len(why.split()) >= 5 for why in EXCLUDED.values())
