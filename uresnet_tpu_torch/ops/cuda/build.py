"""Build the package's CUDA sources into one shared library and load it.

``uresnet_tpu_torch/csrc/*.cu`` are compiled with nvcc for ``sm_90a``, one
nvcc per source, all started together, and linked into a shared library
with a plain C interface, loaded with ctypes — no PyTorch headers, so a
build takes seconds. The library lands in ``build/uresnet_tpu_torch/`` at
the repo root, named by a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags: a changed source or header rebuilds, an
unchanged tree is reused.
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "uresnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def library_path() -> Path:
    """Where the library of the current csrc/*.cu, csrc/*.cuh and flags
    lives: named by a hash of all of them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liburesnet_kernels_{h.hexdigest()[:16]}.so"


def _nvcc(cmd):
    """Run one nvcc command: (its output, its wall seconds). Raises with
    nvcc's output if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr, time.perf_counter() - t0


def build() -> Path:
    """Compile csrc/*.cu (if not built yet) and return the library's path:
    one nvcc per source, all started together, then one link. nvcc's
    output (ptxas register/shared-memory report) is kept beside it as
    ``<lib>.log``, each command's wall seconds on an ``nvcc`` line at its
    end."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [lib.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in sources]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(sources, objs)]
    try:
        with ThreadPoolExecutor(len(cmds)) as pool:
            runs = list(pool.map(_nvcc, cmds))  # raises the first failure
        runs.append(_nvcc([nvcc, "-shared", "-o", str(tmp), *map(str, objs)]))
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    names = [src.name for src in sources] + ["link"]
    lib.with_suffix(".so.log").write_text(
        "".join(out for out, _ in runs)
        + "".join(f"nvcc {n}: {t:.2f} s\n" for n, (_, t) in zip(names, runs)))
    os.replace(tmp, lib)  # atomic: concurrent builders never load a torn file
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build on first use and load; one library per process."""
    return ctypes.CDLL(str(build()))
