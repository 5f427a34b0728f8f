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


@pytest.mark.parametrize("name", ["hopper.cuh", "binmax_scan.cu", "extra.h"])
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
