"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into
``<repo>/build/fiode_tpu_torch/lib<name>-<hash>.so`` and loaded with
``ctypes``; the hash of the source names the library, so an edited source
never loads a stale build.  A source may be compiled more than once with
different ``-D`` definitions (``fused_rhs.cu`` per pair of tile counts): the
definitions are part of the library's name.  ``nvcc``'s ``-Xptxas -v`` report (registers,
shared memory, spills) is kept beside it as ``.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "load_library"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fiode_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-split-compile", "0",  # a source's kernels are optimised in parallel
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def load_library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` with ``-D<key>=<value>`` for each pair of
    ``defines`` if its build is missing, then load it."""
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    tag = "".join(f"-{k.lower()}{v}" for k, v in defines)
    lib = BUILD_DIR / f"lib{name}-{digest}{tag}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines),
             "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}"
            )
        tmp.replace(lib)
    return ctypes.CDLL(str(lib))

