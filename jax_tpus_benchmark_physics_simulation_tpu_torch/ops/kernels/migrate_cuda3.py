"""Kernels B6 and B7: the cell-grid rebuild permutation (3D).

Replace the TPU kernels ``ops/kernels/migrate_pallas3.py:
_migrate_kernel3_compact`` (B6, the default) and ``:_migrate_kernel3`` (B7,
``compact=False``, B6's parity oracle) of the JAX package, both built by
``make_migrate_kernel3``. On the card both are one scatter, the CUDA source
``csrc/migrate3.cu``; its header says why the TPU's mover compaction buys
nothing there and what bounds the scatter on an H100.

``scode`` is the (ncx, cap, ncy * ncz) int32 source-frame code grid from
``GridMD3._migration_dest3``: ``dcode * cap + a`` for a slot moving in
direction ``dcode = ((dx+1)*3 + (dy+1))*3 + (dz+1)`` to slot ``a`` of its
target cell, -1 for an empty or invalid slot. ``fields`` is one stacked
(F, ncx, cap, ncy * ncz) float32 tensor, so one launch moves every field.

- :func:`migrate3_reference`: the plain PyTorch version;
- :func:`mover_overflow`: B6's loud flag, computed from the codes as the
  JAX package's ``compact_fields`` does;
- :func:`migrate3`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- ``LAUNCHES`` / ``FLAT_LAUNCHES``: launches as B6 (with ``k_mov``) and as
  B7 (without), counted where the wrapper launches them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

LAUNCHES = 0
FLAT_LAUNCHES = 0
MAX_FIELDS = 16  # kMaxFields in csrc/migrate3.cu
STAY = 13  # dcode of (dx, dy, dz) == (0, 0, 0)


def migrate3_reference(
    scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float]
) -> torch.Tensor:
    """Plain PyTorch version: ``out[f, target(s)] = fields[f, s]`` for every
    source slot ``s`` with a valid code, ``fills[f]`` everywhere else."""
    n_fields, c, cap, plane = fields.shape
    fill = torch.tensor(list(fills), dtype=fields.dtype, device=fields.device)
    out = fill.view(n_fields, 1).expand(n_fields, c * cap * plane).clone()
    code = scode.reshape(-1)
    src = torch.arange(code.numel(), device=code.device)
    ok = (code >= 0) & (code < 27 * cap)
    src = src[ok]
    code = code[ok]
    dcode = torch.div(code, cap, rounding_mode="floor")
    a = code % cap
    lane = src % plane
    tx = (torch.div(src, cap * plane, rounding_mode="floor") + torch.div(dcode, 9, rounding_mode="floor") - 1) % c
    ty = (torch.div(lane, c, rounding_mode="floor") + torch.div(dcode, 3, rounding_mode="floor") % 3 - 1) % c
    tz = (lane % c + dcode % 3 - 1) % c
    tgt = (tx * cap + a) * plane + ty * c + tz
    out[:, tgt] = fields.reshape(n_fields, -1)[:, src]
    return out.view(n_fields, c, cap, plane)


def mover_overflow(scode: torch.Tensor, k_mov: int) -> torch.Tensor:
    """0-d bool: some source cell has more than ``k_mov`` movers (valid
    slots with ``dcode != 13``), the state in which the TPU's compacted
    kernel B6 drops particles and raises its flag."""
    cap = scode.shape[1]
    is_mov = (scode >= 0) & (torch.div(scode, cap, rounding_mode="floor") != STAY)
    return torch.any(is_mov.sum(1) > k_mov)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_migrate3
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def migrate3(
    scode: torch.Tensor,
    fields: torch.Tensor,
    fills: Sequence[float],
    k_mov: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permute the stacked (F, ncx, cap, ncy * ncz) ``fields`` by ``scode``.
    Returns ``(out, mov_of)``: with ``k_mov`` (B6) ``mov_of`` is
    :func:`mover_overflow`, without it (B7) always False."""
    global LAUNCHES, FLAT_LAUNCHES
    if fields.dim() != 4:
        raise ValueError(f"fields: expected (F, ncx, cap, ncy*ncz), got {tuple(fields.shape)}")
    n_fields, c, cap, plane = fields.shape
    if plane != c * c or tuple(scode.shape) != (c, cap, plane):
        raise ValueError(
            f"scode {tuple(scode.shape)} and fields {tuple(fields.shape)} "
            "do not describe one cubic (ncx, cap, ncy*ncz) grid"
        )
    if fields.dtype != torch.float32 or scode.dtype != torch.int32:
        raise TypeError(f"expected float32 fields and int32 scode, got {fields.dtype}, {scode.dtype}")
    if not (fields.is_contiguous() and scode.is_contiguous()):
        raise ValueError("fields and scode must be contiguous")
    if scode.device != fields.device:
        raise ValueError(f"scode on {scode.device}, fields on {fields.device}")
    if len(fills) != n_fields:
        raise ValueError(f"{len(fills)} fills for {n_fields} fields")
    if k_mov is not None and k_mov < 1:
        raise ValueError(f"k_mov must be positive, got {k_mov}")
    if k_mov is None:
        mov_of = torch.zeros((), dtype=torch.bool, device=fields.device)
    else:
        mov_of = mover_overflow(scode, k_mov)
    if fields.device.type == "cpu":
        return migrate3_reference(scode, fields, fills), mov_of
    if fields.device.type != "cuda":
        raise ValueError(f"migrate3 runs on cpu or cuda tensors, not {fields.device}")
    if n_fields > MAX_FIELDS:
        raise ValueError(f"the migrate3 kernel moves at most {MAX_FIELDS} fields, got {n_fields}")
    out = torch.empty_like(fields)
    host_fills = (ctypes.c_float * n_fields)(*fills)
    status = _launcher()(
        scode.data_ptr(), fields.data_ptr(), out.data_ptr(), host_fills,
        n_fields, c, cap, c, c, fields.device.index,
        torch.cuda.current_stream(fields.device).cuda_stream,
    )
    _build.check(status, "migrate3 kernel")
    if k_mov is None:
        FLAT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, mov_of
