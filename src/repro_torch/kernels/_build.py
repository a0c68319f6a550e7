"""Build and load the hand-written CUDA kernels.

Each ``kernels/csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch/`` at the repository root, then loaded with ``ctypes``.
Nothing is built when the package is imported: the first call of a
kernel's wrapper builds its library, or ``build()`` builds several at once,
one ``nvcc`` process per source, all started together. The library's file
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt.
A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode", "mamba_scan",
           "quant_matmul", "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# called as fn(name, seconds) for each library compiled
# (repro_torch.obs.tracemon registers its build accounting here)
_LISTENERS: List[Callable[[str, float], None]] = []


def add_build_listener(fn: Callable[[str, float], None]) -> None:
    """Call ``fn(name, seconds)`` after each kernel library is built."""
    if fn not in _LISTENERS:
        _LISTENERS.append(fn)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc (on PATH or /usr/local/cuda/bin)")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):   # what a source may include
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, in parallel.

    Returns {name: seconds spent compiling it} (0.0 when already built).
    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills) is
    kept beside each library as ``<library>.log``."""
    names = list(names)
    for name in names:
        if name not in KERNELS:
            raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        Path(f"{out}.log").write_text(log)
        os.replace(tmp, out)
        for fn in _LISTENERS:
            fn(name, seconds[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    return Path(f"{_target(name)}.log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]

