"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes)
and its host code (g++).

Each `nafae_torch/csrc/<name>.cu` is compiled at first use by nvcc into
`build/nafae_torch_kernels/lib<name>_<hash>.so` at the root of the
checkout, for `sm_90a` (Hopper), with a plain C interface that the kernel
modules bind with ctypes. The hash covers the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and a stale
library is never loaded. `build_all` starts one nvcc per source, all at
once. Host code, `csrc/host/<name>.cpp` (the batch packer), is built the
same way by g++ (`load_host`), so it builds on machines without nvcc too.
Nothing here runs at import time: this module is imported on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "nafae_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

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


@functools.cache
def _host_flags() -> tuple[str, ...]:
    """HOST_FLAGS, plus -mf16c where g++ takes it (f32 -> f16 in one
    instruction; the portable rounding gives the same bits)."""
    probe = subprocess.run([_gxx(), "-mf16c", "-x", "c++", "-", "-o",
                            os.devnull], input="int main(){}",
                           capture_output=True, text=True)
    return HOST_FLAGS + (("-mf16c",) if probe.returncode == 0 else ())


def _gxx() -> str:
    return shutil.which("g++") or "g++"


def host_library_path(name: str) -> Path:
    """The library's path; the hash covers the source, the flags, the
    machine and g++'s version, so a library built elsewhere is not
    loaded."""
    src = CSRC / "host" / f"{name}.cpp"
    version = subprocess.run([_gxx(), "-dumpfullversion"],
                             capture_output=True, text=True).stdout
    h = hashlib.sha256(src.read_bytes() + " ".join(
        (*_host_flags(), platform.machine(), version)).encode())
    return BUILD_DIR / f"lib{name}_host_{h.hexdigest()[:16]}.so"


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The built library of csrc/host/<name>.cpp, built by g++ at first
    use (to a temporary name, then renamed: concurrent builders and
    readers never see half a library); raises if the build fails."""
    out = host_library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [_gxx(), *_host_flags(), "-o", str(tmp),
             str(CSRC / "host" / f"{name}.cpp"), "-lpthread"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on csrc/host/{name}.cpp (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
