"""The CUDA build's cache key (``cuda_build.source_digest``), on the CPU: no
nvcc is needed to compute it."""

import pytest

from pika_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include "helpers.cuh"\n__global__ void k() {}\n')
    (tmp_path / "helpers.cuh").write_text("#pragma once\n")
    return tmp_path


def test_digest_changes_with_a_header(csrc):
    before = cuda_build.source_digest(csrc)
    (csrc / "helpers.cuh").write_text("#pragma once\n// changed\n")
    assert cuda_build.source_digest(csrc) != before


def test_digest_changes_with_a_flag(csrc):
    before = cuda_build.source_digest(csrc)
    assert cuda_build.source_digest(csrc, (*cuda_build.NVCC_FLAGS, "-lineinfo")) != before
    assert cuda_build.source_digest(csrc, cuda_build.NVCC_FLAGS) == before


def test_digest_ignores_unrelated_files(csrc):
    before = cuda_build.source_digest(csrc)
    (csrc / "notes.txt").write_text("not a source\n")
    (csrc / "gen.py").write_text("print()\n")
    assert cuda_build.source_digest(csrc) == before
