"""Build the port's CUDA kernels with nvcc into shared libraries.

Each ``kernels/<name>.cu`` has a plain C interface and compiles alone
into ``kernels/_build/lib<name>_<hash>.so`` (the directory is git-
ignored).  The hash covers the source, every header ``kernels/*.cuh``
(the 3xTF32 tensor-core helpers of ``mma_tf32x3.cuh``, the TMA ring of
``tma_ring.cuh``, the warpgroup products and tensor copies of
``wgmma_bf16.cuh``, the block geometry the flash kernels' bf16 forms
share, ``flash_bf16.cuh``) and the nvcc flags, extra defines included,
so an edited source or header never loads a stale build.  ``build_all``
starts one nvcc per source at once and waits for all of them.  Kernels
are built at first use, never at import: a machine without nvcc imports
the package and runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Sequence

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
SOURCES = ("fused_attention", "fused_attention_bwd", "flash_attention",
           "flash_attention_bwd", "flash_attention_wide")

#: -Xptxas -v prints registers, shared memory and spills per kernel into
#: the build log beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from source at first use")
    return found


def _paths(name: str, defines: Sequence[str] = ()):
    src = os.path.join(KERNEL_DIR, name + ".cu")
    h = hashlib.sha256()
    for path in [src, *sorted(glob.glob(os.path.join(KERNEL_DIR, "*.cuh")))]:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    digest = h.hexdigest()[:12]
    stem = os.path.join(BUILD_DIR, f"lib{name}_{digest}")
    return src, stem + ".so", stem + ".log"


def build_all(names: Sequence[str] = SOURCES,
              defines: Sequence[str] = ()) -> Dict[str, str]:
    """{name: path of its .so}, compiling the ones not built yet, all
    nvcc processes at once; ``defines`` (e.g. ``-DTS_BWD_TRACE``) are
    passed to every nvcc."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, str] = {}
    procs: List = []
    for name in names:
        src, lib, log_path = _paths(name, defines)
        out[name] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp, src]
        log_f = open(log_path, "w", encoding="utf-8")
        procs.append((name, tmp, lib, log_path, log_f,
                      subprocess.Popen(cmd, stdout=log_f,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, lib, log_path, log_f, proc in procs:
        rc = proc.wait()
        log_f.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}, log {log_path})")
            continue
        os.replace(tmp, lib)  # atomic: a reader never loads a partial .so
    if failed:
        raise RuntimeError("kernel build failed: " + "; ".join(failed))
    return out


def build(name: str, defines: Sequence[str] = ()) -> str:
    return build_all([name], defines)[name]


def build_log(name: str) -> str:
    """The compiler's output of the current build of ``name`` ("" when
    it has not been built)."""
    _, _, log_path = _paths(name)
    if not os.path.exists(log_path):
        return ""
    with open(log_path, "r", encoding="utf-8") as f:
        return f.read()

