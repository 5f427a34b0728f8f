"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); the reference loads nothing of the program."""

import os
import subprocess
import sys

from portbench.harness import FORBIDDEN, forbidden_modules

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))

DRY_RUN = f'''
import sys
sys.path[:0] = [{REPO!r}, {HERE!r}]
import tempfile
from tiny import make_root
from portbench import harness
with tempfile.TemporaryDirectory() as tmp:
    root = make_root(tmp)
    r = harness.run_cell("tiny.batch", 11, 0.5, False, device="cpu", repo=root)
assert r["correct"], r
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
'''

REFERENCE = f'''
import sys
sys.path.insert(0, {REPO!r})
import portbench.reference, portbench.judge, portbench.control
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split()[-1000:])


def test_a_dry_run_loads_no_jax():
    tops = _tops(DRY_RUN)
    assert "coltt_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE)
    assert not tops & {"coltt_tpu_torch", *FORBIDDEN}


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "coltt_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert "coltt_tpu_torchx" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in forbidden_modules()
