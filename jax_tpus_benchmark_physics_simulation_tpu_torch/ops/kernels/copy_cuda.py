"""Kernel B10: the chunked copy of the op suite's ``pallas_copy`` bandwidth op.

Replaces the TPU kernel ``bench/ops.py:_copy_kernel`` of the JAX package
(built by ``make_bandwidth_op(mode="pallas_copy")``). The CUDA source is
``csrc/copy.cu``; its header says what bounds it on an H100 (bytes: each
read once and written once) and how it is laid out (16-byte vectors, a
grid-stride loop, four loads in flight a thread).

- :func:`copy_reference`: the plain version, ``src.clone()``;
- :func:`chunked_copy`: a new copy of a 1-D float32 or bfloat16 tensor. A
  CPU tensor takes the plain version, a CUDA tensor launches the kernel or
  raises. The JAX op's truncation to whole chunks is the caller's,
  ``bench.ops.make_bandwidth_op``;
- ``COPY_LAUNCHES``: kernel launches, counted where the wrapper launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

COPY_LAUNCHES = 0

DTYPES = (torch.float32, torch.bfloat16)


def copy_reference(src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return src.clone()


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chunked_copy(src: torch.Tensor) -> torch.Tensor:
    """A new tensor holding a copy of the 1-D ``src``."""
    global COPY_LAUNCHES
    if src.dtype not in DTYPES:
        raise TypeError(f"src: expected float32 or bfloat16, got {src.dtype}")
    if src.dim() != 1:
        raise ValueError(f"src: expected a 1-D tensor, got shape {tuple(src.shape)}")
    if not src.is_contiguous():
        raise ValueError("src: expected a contiguous tensor")
    if src.device.type == "cpu":
        return copy_reference(src)
    if src.device.type != "cuda":
        raise ValueError(f"chunked_copy runs on cpu or cuda tensors, not {src.device}")
    if src.data_ptr() % 16:
        raise ValueError("src: expected a 16-byte aligned start (the kernel moves 16-byte vectors)")
    dst = torch.empty_like(src)
    status = _launcher()(
        src.data_ptr(), dst.data_ptr(), src.numel() * src.element_size(),
        src.device.index, torch.cuda.current_stream(src.device).cuda_stream,
    )
    _build.check(status, "copy kernel")
    COPY_LAUNCHES += 1
    return dst
