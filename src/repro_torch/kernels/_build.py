"""Builds the CUDA sources under `csrc/` at first use and binds them with ctypes.

Every `csrc/*.cu` becomes one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/<hash>/lib<name>.so csrc/<name>.cu

All sources are compiled together, one `nvcc` process each, the first time any
kernel is asked for. The build directory is keyed by a hash of every file under
`csrc/`, so an edited source is rebuilt and an unchanged one is reused. It is
`build/repro_torch_kernels/` at the root of the checkout. Nothing here runs at
import time, and a failed build or load raises: there is no other way to a
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# `enum DType` of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2,
               torch.float16: 3, torch.int8: 4, torch.uint8: 5,
               torch.int16: 6, torch.uint16: 7, torch.uint32: 8,
               torch.float8_e4m3fn: 9, torch.float8_e5m2: 10}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Optional[float] = None     # wall time of the last real build
build_log: List[str] = []                 # nvcc output of the last real build


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash(csrc: Path = CSRC) -> str:
    """The build directory's key: every source and header under `csrc`,
    and the flags."""
    h = hashlib.sha256()
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of repro_torch cannot be built on this machine")


def build_all(verbose: bool = False) -> Path:
    """Compile every `csrc/*.cu` that is not built yet, all in parallel.
    Returns the directory holding the libraries. `verbose` adds
    `-Xptxas -v` so that `build_log` shows registers, shared memory, spills."""
    global build_seconds
    out_dir = build_dir() / _source_hash()
    todo = [s for s in _sources()
            if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    build_log.clear()
    failed = []
    done = {}                # each nvcc's output and wall seconds, as it ends

    def wait(src, proc):
        out, _ = proc.communicate()
        done[src] = out, time.time() - t0
    waiters = [threading.Thread(target=wait, args=(src, proc))
               for src, _, proc in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for src, tmp, proc in procs:
        out, seconds = done[src]
        build_log.append(f"== {src.name} (exit {proc.returncode}, "
                         f"{seconds:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    build_seconds = time.time() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(build_log))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu`, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not (CSRC / f"{name}.cu").exists():
                raise RuntimeError(f"no kernel source csrc/{name}.cu")
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
