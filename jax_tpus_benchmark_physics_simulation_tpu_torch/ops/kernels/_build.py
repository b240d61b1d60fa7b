"""Builds ``csrc/*.cu`` with ``nvcc`` at first use and loads the result with
``ctypes``.

The sources have a plain C interface and include no PyTorch header (the
shared ``csrc/*.cuh`` headers are found beside them). One
``nvcc`` process per source compiles them all at once, then one more links
the objects into a shared library, in seconds. The library is named by a
hash of the sources, headers and flags and lands in ``build/`` beside this file
(git-ignored), so an edited source is rebuilt and an unchanged one is loaded
again. A failed build raises; nothing falls back and nothing is downloaded.
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
# version only in summation order, unless its source writes an FMA or an
# approximate reciprocal itself, as B8's does (its header says so).
# -Xptxas -v writes each kernel's registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and the headers they include
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libjtps_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under private names, then rename: concurrent processes never
        # load a half-written library
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
        failed = [o for p, o in zip(procs, outs) if p.returncode != 0]
        if not failed:
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stdout + proc.stderr)
        lib_path.with_suffix(".log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
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
