"""Builds ``csrc/*.cu`` with ``nvcc`` at first use and loads the result with
``ctypes``.

The sources have a plain C interface and include no PyTorch header, so one
``nvcc`` call builds them in seconds. The library is named by a hash of the
sources and flags and lands in ``build/`` beside this file (git-ignored),
so an edited source is rebuilt and an unchanged one is loaded again. A
failed build raises; nothing falls back and nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
# No --use_fast_math: the pair math's division stays IEEE-exact. No FMA
# contraction (--fmad=false): each pair term rounds as the plain PyTorch
# version's separate eager ops do, so a kernel differs from its plain
# version only in summation order. -Xptxas -v writes each kernel's
# registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: cannot build csrc/*.cu")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in a process."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libjtps_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a private name, then rename: concurrent processes
        # never load a half-written library
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lib_path.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.jtps_error_string.argtypes = [ctypes.c_int]
    lib.jtps_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (``cudaGetLastError``
    right after the launch: a refused launch never runs and a later
    synchronize would not report it)."""
    if status != 0:
        name = library().jtps_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({name})")
