"""The port's quickstart against the JAX package's ``examples/quickstart.py``.

Each runs in its own interpreter, the port's with ``--device cpu`` and the
reference under ``JAX_PLATFORMS=cpu``, each in a work directory of its
own. Both must end well and print the same lines: the same top-hit ids
and scores within 0.1, as printed (one decimal). Core mode's ids are
snowflake ids, made from the clock, so they cannot match across runs:
there both must print an id (its own script asserts that it is the id
its bulk insert gave row 7).
"""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^(edge|core|experimental): .*top hit (\S+) score=([-0-9.]+)")


def _run(cmd, env):
    env = dict(os.environ, **env)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")]))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "all three engines OK", proc.stdout
    hits = {}
    for line in lines:
        m = LINE.match(line)
        if m:
            hits[m.group(1)] = (m.group(2), float(m.group(3)))
    assert set(hits) == {"edge", "core", "experimental"}, proc.stdout
    return hits


def test_quickstart_matches_the_reference(tmp_path):
    port = _run([sys.executable, "-m", "coltt_tpu_torch.quickstart",
                 str(tmp_path / "port"), "--device", "cpu"], {})
    ref = _run([sys.executable, os.path.join("examples", "quickstart.py"),
                str(tmp_path / "ref")], {"JAX_PLATFORMS": "cpu"})
    for mode in ("edge", "experimental"):
        assert port[mode][0] == ref[mode][0], (mode, port, ref)
    assert port["core"][0].isdigit() and ref["core"][0].isdigit()
    for mode in port:
        assert abs(port[mode][1] - ref[mode][1]) <= 0.1, (mode, port, ref)


def test_quickstart_on_cuda_needs_a_card(tmp_path):
    """``--device cuda`` (the default) never falls back to the host."""
    from coltt_tpu_torch import quickstart

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([str(tmp_path)])
