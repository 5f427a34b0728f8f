"""The port never loads JAX nor the JAX package.

Every module of ``coltt_tpu_torch`` is imported in a fresh interpreter,
which must then hold neither ``jax`` nor ``coltt_tpu`` (nor any of their
submodules) in ``sys.modules``; and ``chip_smoke.py``, which runs where no
JAX is wanted, imports neither name anywhere in its code.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "coltt_tpu")
# the core mode's modules, named so that a walk that misses them fails
CORE_MODULES = (
    "coltt_tpu_torch.native", "coltt_tpu_torch.storage.wal",
    "coltt_tpu_torch.storage.kv", "coltt_tpu_torch.utils.snowflake",
    "coltt_tpu_torch.utils.cron", "coltt_tpu_torch.utils.sortedkeys",
    "coltt_tpu_torch.store.hnsw", "coltt_tpu_torch.engine.core",
    "coltt_tpu_torch.bench_hnsw",
)
# the multi-device and S3 modules
PARALLEL_MODULES = (
    "coltt_tpu_torch.parallel.mesh", "coltt_tpu_torch.parallel.multihost",
    "coltt_tpu_torch.parallel.dist_search", "coltt_tpu_torch.parallel.convert",
    "coltt_tpu_torch.storage.s3", "coltt_tpu_torch.bench_scaling",
)
# the selection frontier's bench and the quickstart
ENTRY_MODULES = ("coltt_tpu_torch.bench_frontier", "coltt_tpu_torch.quickstart")
# the subpackages whose __all__ the port re-exports, and the names of the
# reference's that have no torch counterpart: jax.sharding partition specs
SUBPACKAGES = ("", ".ops", ".engine", ".store", ".storage", ".index", ".utils",
               ".parallel")
NOT_PORTED = {"shard_spec", "replicated_spec", "batch_spec"}

_PROBE = """
import importlib, pkgutil, sys
import coltt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(coltt_tpu_torch.__path__, "coltt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
banned = {banned!r}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), loaded)
print(" ".join(names))
sys.exit(1 if loaded else 0)
"""


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


def test_port_modules_never_load_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(banned=BANNED)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 30, proc.stdout  # every module was walked
    walked = set(proc.stdout.splitlines()[1].split())
    assert set(CORE_MODULES) <= walked, set(CORE_MODULES) - walked
    assert set(PARALLEL_MODULES) <= walked, set(PARALLEL_MODULES) - walked
    assert set(ENTRY_MODULES) <= walked, set(ENTRY_MODULES) - walked


def _reference_all(sub: str) -> list:
    """The ``__all__`` of ``coltt_tpu<sub>``, read from its source (an
    import would load JAX)."""
    path = os.path.join(REPO, "coltt_tpu", *sub.split(".")[1:], "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__" for t in node.targets)):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: "coltt_tpu" + s)
def test_port_exports_the_reference_names(sub):
    """Every name of the reference subpackage's ``__all__`` but the
    jax.sharding specs imports from the port's, in a fresh interpreter
    (so that an import cycle through a package ``__init__`` shows), and
    stands in the port's ``__all__``."""
    want = [n for n in _reference_all(sub) if n not in NOT_PORTED]
    assert want
    probe = (f"import sys\nfrom coltt_tpu_torch{sub} import {', '.join(want)}\n"
             f"import coltt_tpu_torch{sub} as m\n"
             f"print(sorted(set({want!r}) - set(m.__all__)))\n"
             f"sys.exit(any(k.split('.')[0] in {BANNED!r} for k in sys.modules))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names and not [n for n in names if _banned(n)], names
    assert any(n.startswith("coltt_tpu_torch") for n in names)
