"""The kernel build cache (gs2d_torch/cuda_build.py) keys each library on
everything that goes into it: its source, every header of csrc/ and the
compiler flags. Runs without nvcc: only the library path is computed."""

import shutil

import pytest

from gs2d_torch import cuda_build


@pytest.fixture
def src(tmp_path, monkeypatch):
    """A copy of csrc/ that the build reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(cuda_build.SRC_DIR, copy)
    monkeypatch.setattr(cuda_build, "SRC_DIR", copy)
    return copy


def test_kernels_include_the_shared_header():
    for name in ("rasterize_fwd", "rasterize_bwd"):
        text = (cuda_build.SRC_DIR / f"{name}.cu").read_text()
        assert '#include "raster_common.cuh"' in text


@pytest.mark.parametrize("name", cuda_build.KERNELS)
def test_path_is_stable_for_unchanged_inputs(src, name):
    assert cuda_build._lib_path(name) == cuda_build._lib_path(name)
    assert cuda_build._lib_path(name).parent == cuda_build.BUILD_DIR


@pytest.mark.parametrize("name", cuda_build.KERNELS)
def test_header_edit_changes_every_path(src, name):
    """A kernel built before an edit to raster_common.cuh is not loaded
    after it: the library's name changes with the header's bytes."""
    before = cuda_build._lib_path(name)
    header = src / "raster_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert cuda_build._lib_path(name) != before


def test_source_edit_changes_only_its_path(src):
    before = {n: cuda_build._lib_path(n) for n in cuda_build.KERNELS}
    cu = src / "rasterize_bwd.cu"
    cu.write_bytes(cu.read_bytes() + b"\n")
    after = {n: cuda_build._lib_path(n) for n in cuda_build.KERNELS}
    assert after["rasterize_bwd"] != before["rasterize_bwd"]
    assert after["rasterize_fwd"] == before["rasterize_fwd"]


def test_new_header_and_flags_change_the_path(src, monkeypatch):
    before = cuda_build._lib_path("rasterize_fwd")
    (src / "extra.cuh").write_text("#pragma once\n")
    with_header = cuda_build._lib_path("rasterize_fwd")
    assert with_header != before
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build._lib_path("rasterize_fwd") != with_header


def test_compiler_report_is_kept_beside_the_library(src, tmp_path,
                                                    monkeypatch):
    """chip_smoke.py prints ptxas's registers and spills of every kernel,
    also of one built by an earlier process: the report is read back from
    beside the library, without compiling."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    cuda_build.BUILD_DIR.mkdir()
    lib = cuda_build._lib_path("rasterize_fwd")
    lib.write_bytes(b"")
    assert cuda_build.compiler_report("rasterize_fwd") == ""
    text = "ptxas info    : Used 56 registers, used 1 barriers\n"
    lib.with_suffix(".txt").write_text(text)
    assert cuda_build.compiler_report("rasterize_fwd") == text
