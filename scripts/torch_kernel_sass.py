#!/usr/bin/env python3
"""What the port's CUDA kernels compiled to, and the instruction floor of
the fused attention's tanh.

    python3 scripts/torch_kernel_sass.py [--libraries flash_attention_wide]

Needs nvcc and cuobjdump (the CUDA toolkit) and one CUDA card (for its
SM clock).  It builds the port's kernels (kernels/build.py; those named by
--libraries, default every source) and prints,
per kernel function of each library, the SASS instruction count, the
number of 3xTF32 tensor-core instructions (HMMA.1688.F32.TF32), of bf16
mma.sync ones (HMMA.16816 on BF16), of warpgroup products (HGMMA, with
their opcodes: shape, F32 accumulate, BF16 operands) and tensor copies
(UTMALDG), of MUFU instructions, ptxas's registers and spill bytes for
that function, whether ptxas serialized its wgmma instructions (a wait
after every product, warnings C7510-C7520), and ptxas's spill lines.  Then it compiles two probe
kernels into the git-ignored build directory, y[i] = x[i] and
y[i] = tanhf(x[i]), and counts the SASS instructions (and MUFU among
them) that one accurate tanhf adds: with the fused attention's B*K*T*D
tanh per call at the beam-decode shape (16 x 4 x 400 x 512), that count
over the card's FP32 issue rate (132 SMs x 128 lanes per clock at the
maximum SM clock nvidia-smi reports) is the tanh's instruction floor,
and the MUFU count over the MUFU rate (16 per clock per SM) its MUFU
floor.  One JSON line each.

    python3 scripts/torch_kernel_sass.py --compare <other checkout> \
        [--libraries flash_attention flash_attention_bwd]

builds the named libraries (default: every source) in this checkout and
in the other one (its own kernels/build.py, its own build directory),
dumps both with cuobjdump -sass and compares them function by function,
after dropping the per-file hash of the anonymous namespace from the
function names and collapsing whitespace (the column padding varies
between dumps): one JSON line per library, with the functions whose code
differs under the same name; a function found on one side only whose
code equals that of a function found on the other side only (a kernel
made a template keeps its code under a new name) is listed as renamed,
the others as added (this checkout) or removed (the other).  Exit code
1 when a function differs or is removed.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SMS, FP32_LANES, MUFU_PER_CLK = 132, 128, 16  # H100 SXM, per SM per clock
TANH_PER_CALL = 16 * 4 * 400 * 512  # B*K*T*D at the beam-decode shape

PROBE = r"""
extern "C" __global__ void probe_copy(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = x[i];
}
extern "C" __global__ void probe_tanh(const float* x, float* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = tanhf(x[i]);
}
"""

_INSTR = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)")
# ptxas -v: the function a block of lines is about, its spills, registers
_PTXAS_FUNC = re.compile(r"(?:Compiling entry function|Function properties "
                         r"for) '?(\w+)'?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SERIALIZED = re.compile(r"wgmma\.mma_async instructions are "
                               r"serialized .*function '(\w+)'")


def tool(name: str) -> str:
    from textsummarization_on_flink_tpu_torch.kernels import build

    return os.path.join(os.path.dirname(build.nvcc_path()), name)


def sass_counts(path: str):
    """{function: Counter of opcodes} of a library or cubin (NOPs out)."""
    out = subprocess.run([tool("cuobjdump"), "-sass", path],
                         capture_output=True, text=True, check=True).stdout
    funcs = collections.OrderedDict()
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = collections.Counter()
        elif cur is not None:
            m = _INSTR.search(line)
            if m and m.group(1) != "NOP":
                funcs[cur][m.group(1)] += 1
    return funcs


def summary(ops: collections.Counter):
    return dict(instructions=sum(ops.values()),
                hmma_tf32=ops.get("HMMA.1688.F32.TF32", 0),
                hmma_bf16=sum(n for op, n in ops.items()
                              if op.startswith("HMMA.16816") and "BF16" in op),
                hgmma=sum(n for op, n in ops.items()
                          if op.startswith("HGMMA")),
                hgmma_opcodes=sorted({op for op in ops
                                      if op.startswith("HGMMA")}),
                utmaldg=sum(n for op, n in ops.items()
                            if op.startswith("UTMALDG")),
                mufu=sum(n for op, n in ops.items() if op.startswith("MUFU")))


def ptxas_functions(log: str):
    """{mangled function: {registers, spill_stores, spill_loads,
    wgmma_serialized}} from a build log of nvcc -Xptxas -v
    (wgmma_serialized: ptxas's warnings that it serialized the function's
    wgmma instructions, 0 when none)."""
    funcs = collections.defaultdict(lambda: dict(wgmma_serialized=0))
    cur = None
    for line in log.splitlines():
        m = _PTXAS_SERIALIZED.search(line)
        if m:
            funcs[m.group(1)]["wgmma_serialized"] += 1
            continue
        m = _PTXAS_FUNC.search(line)
        if m:
            cur = m.group(1)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            funcs[cur].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = _PTXAS_REGS.search(line)
        if m:
            funcs[cur]["registers"] = int(m.group(1))
    return funcs


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()
    return float(out[0]) * 1e6


# the anonymous namespace's name in a mangled function name: its length
# prefix and a hash of the file (_ZN56_GLOBAL__N__<hash>_<len>_<file>_cu_
# <hash>), which are not code
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def normalized_sass(path: str):
    """{function: its SASS with whitespace collapsed}, the anonymous
    namespace's hash dropped from every name."""
    out = subprocess.run([tool("cuobjdump"), "-sass", path],
                         capture_output=True, text=True, check=True).stdout
    funcs = collections.OrderedDict()
    cur = None
    for line in out.splitlines():
        line = " ".join(_ANON.sub("_GLOBAL__N_", line).split())
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = []
        elif cur is not None and line:
            funcs[cur].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def compare(other: str, names) -> int:
    """Print, per library, whether this checkout's SASS equals the other
    checkout's, function by function; 1 when any differs or is gone."""
    from textsummarization_on_flink_tpu_torch.kernels import build

    here = build.build_all(names)
    code = ("import json; from textsummarization_on_flink_tpu_torch.kernels "
            "import build; print(json.dumps(build.build_all("
            f"{list(names)!r})))")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(other))
    there = json.loads(subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=os.path.abspath(other),
        capture_output=True, text=True, check=True).stdout.splitlines()[-1])
    rc = 0
    for name in names:
        a, b = normalized_sass(here[name]), normalized_sass(there[name])
        differing = sorted(f for f in set(a) & set(b) if a[f] != b[f])
        only_there = {b[f]: f for f in set(b) - set(a)}
        renamed = {f: only_there[a[f]] for f in set(a) - set(b)
                   if a[f] in only_there}
        added = sorted(set(a) - set(b) - set(renamed))
        removed = sorted(set(b) - set(a) - set(renamed.values()))
        rc |= bool(differing or removed)
        print(json.dumps(dict(library=name, functions=len(a),
                              other_functions=len(b),
                              equal=not (differing or added or removed),
                              differing=differing, renamed=renamed,
                              added=added, removed=removed,
                              here=here[name], other=there[name])))
    return rc


def main(argv=None) -> int:
    import argparse

    from textsummarization_on_flink_tpu_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", metavar="CHECKOUT")
    ap.add_argument("--libraries", nargs="+", default=list(build.SOURCES))
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare, args.libraries)
    libs = build.build_all(args.libraries)
    for name, lib in libs.items():
        spills = [ln.strip() for ln in build.build_log(name).splitlines()
                  if "spill" in ln]
        print(json.dumps(dict(library=name, spill_lines=sorted(set(spills)))))
        ptxas = ptxas_functions(build.build_log(name))
        for func, ops in sass_counts(lib).items():
            print(json.dumps(dict(library=name, function=func,
                                  **summary(ops), **ptxas.get(func, {}))))

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    src = os.path.join(build.BUILD_DIR, "tanh_probe.cu")
    cubin = os.path.join(build.BUILD_DIR, "tanh_probe.cubin")
    with open(src, "w", encoding="utf-8") as f:
        f.write(PROBE)
    subprocess.run([build.nvcc_path(), "-cubin", "-arch=sm_90a", "-O3",
                    "-o", cubin, src], check=True)
    funcs = sass_counts(cubin)
    copy = summary(next(v for k, v in funcs.items() if "probe_copy" in k))
    tanh = summary(next(v for k, v in funcs.items() if "probe_tanh" in k))
    per_tanh = tanh["instructions"] - copy["instructions"]
    mufu = tanh["mufu"] - copy["mufu"]
    clk = max_sm_clock_hz()
    print(json.dumps(dict(
        tanhf_sass_instructions=per_tanh, tanhf_mufu=mufu,
        tanh_opcodes=dict(funcs[next(k for k in funcs if "probe_tanh" in k)]),
        max_sm_clock_mhz=clk / 1e6, tanh_per_call=TANH_PER_CALL,
        tanh_issue_floor_ms=TANH_PER_CALL * per_tanh
        / (SMS * FP32_LANES * clk) * 1e3,
        tanh_mufu_floor_ms=TANH_PER_CALL * mufu
        / (SMS * MUFU_PER_CLK * clk) * 1e3)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
