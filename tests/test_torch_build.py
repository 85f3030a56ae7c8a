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


def test_varlen_sources_include_the_tile_and_order_headers():
    for name in ("flash_varlen_fwd", "flash_varlen_bwd"):
        assert _build._sources(name) == [f"{name}.cu", "flash_tc.cuh",
                                         "varlen_order.cuh"]


def test_every_header_is_included_by_a_kernel():
    included = {h for k in ck.KERNELS for h in _build._sources(k.name)}
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert headers and headers <= included


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd",
                                  "flash_varlen_fwd", "flash_varlen_bwd"])
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


def test_chip_smoke_reads_registers_and_spills_per_instantiation():
    # what nvcc -Xptxas=-v prints per entry function; chip_smoke.py fails
    # when a tensor-core (_tc) instantiation spills
    import chip_smoke
    log = "\n".join([
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_131"
        "flash_varlen_bwd_dkdv_kernel_tcILi64EEEvPK13__nv_bfloat16S3_",
        "    0 bytes stack frame, 54 bytes spill stores, 54 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_123"
        "flash_varlen_fwd_kernelIfLi256EEEvPKT_S3_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 127 registers, used 1 barriers",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_122"
        "paged_attention_kernelI13__nv_bfloat16EEvPKT_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers"])
    assert chip_smoke.ptxas_instantiations(log) == {
        "flash_varlen_bwd_dkdv_kernel_tc<64>": {"spill_stores": 54,
                                                "registers": 168},
        "flash_varlen_fwd_kernel<float, 256>": {"spill_stores": 0,
                                                "registers": 127},
        "paged_attention_kernel<bf16>": {"spill_stores": 0,
                                         "registers": 40}}


def test_chip_smoke_names_fp16_instantiations():
    # the 16-bit kernels are templates over their element type: a __half
    # instantiation is fp16 (its mangled "6__half" holds an "f" that must
    # not read as float)
    import chip_smoke
    assert chip_smoke.kernel_name(
        "_ZN12_GLOBAL__N_119flash_fwd_kernel_tcI6__halfLi64EEEvPKT_S4_"
    ) == "flash_fwd_kernel_tc<fp16, 64>"
    assert chip_smoke.kernel_name(
        "_ZN12_GLOBAL__N_118paged_split_kernelI13__nv_bfloat16Li128ELi4EEEv"
    ) == "paged_split_kernel<bf16, 128, 4>"
