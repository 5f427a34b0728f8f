"""The kernel library's build key (``coltt_tpu_torch/ops/native.py``).

The library is rebuilt when, and only when, its hash changes: the hash
covers every source and header under ``csrc/`` and the nvcc flags, so an
edited header that ``binmax_scan.cu`` includes is rebuilt too. Nothing
here compiles: ``_target`` only reads the files.
"""

import os
import shutil

import pytest

from coltt_tpu_torch.ops import native


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(native.CSRC_DIR, dst)
    return str(dst)


def _library(csrc_dir):
    lib = native.KernelLibrary("binmax_scan")
    lib.source = os.path.join(csrc_dir, "binmax_scan.cu")
    return lib


def _edit(path, text="\n// edited\n"):
    with open(path, "a") as f:
        f.write(text)


@pytest.mark.parametrize("name", ["hopper.cuh", "binmax_scan.cu", "extra.h",
                                  "binmax_common.cuh", "binmax_scan_float.cu"])
def test_library_hash_follows_every_source(csrc_copy, name):
    lib = _library(csrc_copy)
    before = lib._target()
    assert os.path.dirname(before) == native.BUILD_DIR
    assert os.path.basename(before).startswith("libbinmax_scan-")
    _edit(os.path.join(csrc_copy, name))
    assert lib._target() != before


def test_library_hash_ignores_other_files(csrc_copy):
    lib = _library(csrc_copy)
    before = lib._target()
    _edit(os.path.join(csrc_copy, "NOTES.txt"), "not a source\n")
    assert lib._target() == before


def test_library_hash_is_the_checkouts(csrc_copy):
    """A copy of csrc/ with the same bytes keys the same library."""
    assert (_library(csrc_copy)._target()
            == native.KernelLibrary("binmax_scan")._target())


def test_libraries_of_k1_and_k2_have_their_own_sources():
    """K1's int8 loop and K2 build from binmax_scan.cu, K1's float loops
    from binmax_scan_float.cu: two libraries, two nvcc runs."""
    from coltt_tpu_torch.ops import fused_scan as fs

    sources = {name: os.path.basename(lib.source) for name, lib in fs._KERNELS.items()}
    assert sources == {"int8": "binmax_scan.cu", "float": "binmax_scan_float.cu"}
    for lib in fs._KERNELS.values():
        assert os.path.isfile(lib.source)


class _FakeLibrary:
    def __init__(self, barrier, fail=False):
        self.barrier, self.fail, self.loaded = barrier, fail, False
        self.calls = 0

    def load(self):
        self.calls += 1
        self.barrier.wait(timeout=10)  # every build has started
        if self.fail:
            raise RuntimeError("nvcc failed")
        self.loaded = True


def test_load_all_builds_together_and_raises_after_all_ended():
    import threading

    barrier = threading.Barrier(3)
    libs = [_FakeLibrary(barrier), _FakeLibrary(barrier, fail=True),
            _FakeLibrary(barrier)]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        native.load_all(libs)
    assert libs[0].loaded and libs[2].loaded
    # loaded libraries are not loaded again: no thread starts
    native.load_all(libs[::2])
    assert libs[0].calls == libs[2].calls == 1
