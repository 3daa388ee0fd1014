"""Build the package's CUDA sources into one shared library and load it.

``uresnet_tpu_torch/csrc/*.cu`` are compiled with nvcc for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes — no PyTorch
headers, so a build takes seconds. The library lands in
``build/uresnet_tpu_torch/`` at the repo root, named by a hash of the
sources and flags: a changed source rebuilds, an unchanged one is reused.
nvcc is looked up on PATH, then under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``). A missing nvcc or a failed compile raises with
nvcc's output; nothing falls back and nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "uresnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels of uresnet_tpu_torch cannot be built")
    return nvcc


def build() -> Path:
    """Compile csrc/*.cu (if not built yet) and return the library's path.
    nvcc's output (ptxas register/shared-memory report) is kept beside it
    as ``<lib>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"liburesnet_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a torn file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build on first use and load; one library per process."""
    return ctypes.CDLL(str(build()))
