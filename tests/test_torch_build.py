"""The kernel build's library names (kernels/build.py), on the CPU: a
library is named by a hash of its source, every ``kernels/*.cuh`` header
and the nvcc flags, so an edited source or header never loads a stale
build.  No nvcc is needed: only the names are computed."""

import os

import pytest

from textsummarization_on_flink_tpu_torch.kernels import build


@pytest.fixture
def kernel_dir(tmp_path, monkeypatch):
    """A kernel directory with one source and one header, in place of the
    package's own."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    return tmp_path


def _lib_name(name="k"):
    return os.path.basename(build._paths(name)[1])


def test_library_name_is_stable(kernel_dir):
    assert _lib_name() == _lib_name()
    assert _lib_name().startswith("libk_") and _lib_name().endswith(".so")


@pytest.mark.parametrize("edit", ["h.cuh", "k.cu", "new.cuh"])
def test_editing_the_source_or_any_header_renames_the_library(kernel_dir,
                                                               edit):
    before = _lib_name()
    path = kernel_dir / edit
    path.write_text((path.read_text() if path.exists() else "") + "// v2\n")
    assert _lib_name() != before


def test_other_files_do_not_rename_the_library(kernel_dir):
    before = _lib_name()
    (kernel_dir / "notes.txt").write_text("not a kernel header\n")
    (kernel_dir / "other.cu").write_text("// another source\n")
    assert _lib_name() == before


def test_package_sources_hash_their_headers():
    """The package's sources include mma_tf32x3.cuh (the flash kernels
    its 3xTF32 products, the fused attention its cp.async staging), which
    lies in the kernel directory the digest reads."""
    assert os.path.exists(os.path.join(build.KERNEL_DIR, "mma_tf32x3.cuh"))
    for name in build.SOURCES:
        src, lib, log = build._paths(name)
        with open(src, encoding="utf-8") as f:
            assert '#include "mma_tf32x3.cuh"' in f.read()
        assert lib.startswith(build.BUILD_DIR) and log.endswith(".log")


@pytest.mark.parametrize("header, names", [
    ("tma_ring.cuh", ("fused_attention", "fused_attention_bwd")),
    ("flash_bf16.cuh", ("flash_attention", "flash_attention_bwd")),
], ids=["tma_ring", "flash_bf16"])
def test_tma_header_renames_both_fused_attention_libraries(tmp_path,
                                                           monkeypatch,
                                                           header, names):
    """A header two sources share renames both libraries when it is
    edited, so neither loads a build of the old code: the fused
    attention's forward and backward include the TMA ring's helpers from
    kernels/tma_ring.cuh, the flash forward and backward their bf16
    forms' block geometry, register split and store from
    kernels/flash_bf16.cuh."""
    import shutil

    for path in os.listdir(build.KERNEL_DIR):
        if path.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(build.KERNEL_DIR, path), tmp_path)
    monkeypatch.setattr(build, "KERNEL_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    for name in names:
        with open(tmp_path / f"{name}.cu", encoding="utf-8") as f:
            assert f'#include "{header}"' in f.read()
    before = {name: _lib_name(name) for name in names}
    path = tmp_path / header
    path.write_text(path.read_text() + "// edited\n")
    assert all(_lib_name(name) != before[name] for name in names)


@pytest.mark.parametrize("defines", [("-DTRACE",), ("-DTRACE", "-DN=2"),
                                     ("-DN=2",)])
def test_defines_rename_the_library(kernel_dir, defines):
    """A build with extra defines (scripts/torch_bwd_phases.py's traced
    build of the backward) is a library of its own, and leaves the plain
    build's name as it was."""
    plain = _lib_name()
    named = os.path.basename(build._paths("k", defines)[1])
    assert named != plain and named.startswith("libk_")
    assert os.path.basename(build._paths("k", ())[1]) == plain
    others = {("-DTRACE",), ("-DTRACE", "-DN=2"), ("-DN=2",)} - {defines}
    assert all(os.path.basename(build._paths("k", d)[1]) != named
               for d in others)
