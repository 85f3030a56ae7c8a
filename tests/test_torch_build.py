"""How ``paddle_tpu_torch/ops/_build.py`` names the kernel libraries: by a
hash of the source, every ``csrc`` header it includes and the compiler
flags, so that an edited header never loads a stale library. Runs on the
CPU: nothing here calls ``nvcc``."""
import shutil

import pytest

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def test_flash_sources_include_the_shared_tile_header():
    for name in ("flash_fwd", "flash_bwd"):
        assert _build._sources(name) == [f"{name}.cu", "flash_tc.cuh"]
    assert _build._sources("paged_attention") == ["paged_attention.cu"]


def test_every_header_is_included_by_a_kernel():
    included = {h for k in ck.KERNELS for h in _build._sources(k.name)}
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert headers and headers <= included


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_editing_an_included_header_renames_the_library(csrc_copy, name):
    before = _build.library_path(name)
    header = csrc_copy / "flash_tc.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


def test_a_header_a_kernel_does_not_include_leaves_its_name(csrc_copy):
    before = _build.library_path("paged_attention")
    header = csrc_copy / "flash_tc.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("paged_attention") == before


def test_libraries_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
