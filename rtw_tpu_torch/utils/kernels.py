"""Build the CUDA kernels of csrc/ with nvcc at first use and load them with
ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers, so
nvcc takes seconds), is compiled for `sm_90a` into
`build/rtw_tpu_torch/<name>-<source hash>.so` at the repository root, and is
bound by its wrapper module.  The build runs from the sources
in the checkout only; the hash covers the source and the shared headers
(`csrc/*.cuh`), so a change to either is rebuilt.  `build_all` starts one
nvcc per source, all at once.
`-Xptxas -v` reports registers, shared memory and spills; the report is
kept in `build_log[name]`.  No `--use_fast_math`; `-fmad=false` keeps each
float operation rounded on its own, as torch's separate elementwise
kernels round it, so the kernel can be held tightly against its plain
version.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
CSRC = os.path.join(_ROOT, "rtw_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "rtw_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-fmad=false"]

build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _tag(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(name: str) -> str:
    """Compile csrc/<name>.cu if its hashed library is missing; returns the
    library path.  The compiler's report goes to build_log[name]."""
    src = os.path.join(CSRC, f"{name}.cu")
    tag = _tag(src)
    so_path = os.path.join(BUILD_DIR, f"{name}-{tag}.so")
    if os.path.exists(so_path):
        build_log.setdefault(name, "(cached build)")
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{build_log[name]}")
    os.replace(tmp, so_path)
    return so_path


def build_all(names) -> None:
    """Build every named source at once, one nvcc process each."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(build, n) for n in names]:
            fut.result()


def ptxas_summary(name: str) -> str:
    """The entry-function, 'Used N registers' and spill lines of the build
    report (each kernel's mangled name, then its registers and spills)."""
    lines = build_log.get(name, "").splitlines()
    keep = [ln.strip() for ln in lines
            if re.search(r"Compiling entry function|registers|spill", ln)]
    return "\n".join(keep) if keep else build_log.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built if needed (unbound: the wrapper
    module declares its C interface)."""
    return ctypes.CDLL(build(name))

