"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `nafae_torch/csrc/<name>.cu` is compiled at first use by nvcc into
`build/nafae_torch_kernels/lib<name>_<hash>.so` at the root of the
checkout, for `sm_90a` (Hopper), with a plain C interface that the kernel
modules bind with ctypes. The hash covers the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and a stale
library is never loaded. `build_all` starts one nvcc per source, all at
once. Nothing here runs at import time: this module is imported on
machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nafae_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the "
                       "port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names) -> None:
    """Builds every csrc/<name>.cu of `names` that is not built yet, one
    nvcc each, all started together; raises if any build fails."""
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            out = library_path(name)
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed on csrc/{name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent reader never sees half
        if failed:
            raise RuntimeError("\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu (built first if needed)."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


def build_log(name: str) -> str:
    """nvcc's output for the current build of csrc/<name>.cu (registers,
    shared memory and spills per kernel, from -Xptxas -v), or "" when the
    library was built by another process that kept no log."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
