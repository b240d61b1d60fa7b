"""Kernels B6 and B7: the cell-grid rebuild permutation (3D), and B6's
halo form.

Replace the TPU kernels ``ops/kernels/migrate_pallas3.py:
_migrate_kernel3_compact`` (B6, the default) and ``:_migrate_kernel3`` (B7,
``compact=False``, B6's parity oracle) of the JAX package, both built by
``make_migrate_kernel3``, and, as B6 halo, B6's explicit-halo call ``.raw``
(``migrate_pallas3.py:471``) that the row-sharded engine runs on each
device's x-rows. On the card each is one scatter, the CUDA source
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
- :func:`migrate3_halo_reference` / :func:`migrate3_halo`: B6 halo on one
  rank's ``rows`` x-rows; ``scode`` and ``fields`` carry one halo x-row on
  each side, the output only the local rows, and a source whose target row
  lies outside them is dropped (its owner moves it from its own halo copy).
  ``mov_of`` is the local rows' flag; the engine reduces it over ranks.
  Halo rows travel whole, not compacted to ``k_mov`` planes as on the TPU
  (``csrc/migrate3.cu`` says why);
- ``LAUNCHES`` / ``FLAT_LAUNCHES`` / ``HALO_LAUNCHES``: launches as B6 (with
  ``k_mov``), as B7 (without) and as B6 halo, counted where the wrappers
  launch them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda import check_migrate_args

LAUNCHES = 0
FLAT_LAUNCHES = 0
HALO_LAUNCHES = 0
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


@functools.lru_cache(maxsize=None)
def _halo_launcher():
    fn = _build.library().jtps_migrate3_halo
    fn.argtypes = _launcher().argtypes
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
    check_migrate_args(scode, fields, fills, MAX_FIELDS)
    mov_of = _mov_of(scode, k_mov)
    if fields.device.type == "cpu":
        return migrate3_reference(scode, fields, fills), mov_of
    out = _launch(_launcher(), scode, fields, fills, c, c, "migrate3 kernel")
    if k_mov is None:
        FLAT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, mov_of


def migrate3_halo_reference(scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of B6 halo: ``out[f, target(s)] = fields[f, s]``
    for every source slot ``s`` of the extended x-rows whose valid code
    names a slot in the local rows, ``fills[f]`` everywhere else."""
    n_fields, ext_rows, cap, plane = fields.shape
    rows = ext_rows - 2
    c = math.isqrt(plane)
    fill = torch.tensor(list(fills), dtype=fields.dtype, device=fields.device)
    out = fill.view(n_fields, 1).expand(n_fields, rows * cap * plane).clone()
    code = scode.reshape(-1)
    src = torch.arange(code.numel(), device=code.device)
    dcode = torch.div(code, cap, rounding_mode="floor")
    # extended row + dx - 1: the local target row
    tx = torch.div(src, cap * plane, rounding_mode="floor") + torch.div(dcode, 9, rounding_mode="floor") - 2
    ok = (code >= 0) & (code < 27 * cap) & (tx >= 0) & (tx < rows)
    src, code, dcode, tx = src[ok], code[ok], dcode[ok], tx[ok]
    lane = src % plane
    ty = (torch.div(lane, c, rounding_mode="floor") + torch.div(dcode, 3, rounding_mode="floor") % 3 - 1) % c
    tz = (lane % c + dcode % 3 - 1) % c
    tgt = (tx * cap + code % cap) * plane + ty * c + tz
    out[:, tgt] = fields.reshape(n_fields, -1)[:, src]
    return out.view(n_fields, rows, cap, plane)


def migrate3_halo(
    scode: torch.Tensor,
    fields: torch.Tensor,
    fills: Sequence[float],
    k_mov: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 halo: permute the stacked (F, rows + 2, cap, ncy * ncz) ``fields``
    by ``scode`` into the (F, rows, cap, ncy * ncz) local rows. Returns
    ``(out, mov_of)``, ``mov_of`` of the local rows' codes."""
    global HALO_LAUNCHES
    if fields.dim() != 4:
        raise ValueError(f"fields: expected (F, rows + 2, cap, ncy*ncz), got {tuple(fields.shape)}")
    n_fields, ext_rows, cap, plane = fields.shape
    c = math.isqrt(plane)
    if ext_rows < 3 or c * c != plane or tuple(scode.shape) != (ext_rows, cap, plane):
        raise ValueError(
            f"scode {tuple(scode.shape)} and fields {tuple(fields.shape)}: expected "
            "(rows + 2, cap, c*c) and (F, rows + 2, cap, c*c) with rows >= 1"
        )
    check_migrate_args(scode, fields, fills, MAX_FIELDS)
    mov_of = _mov_of(scode[1:-1], k_mov)
    if fields.device.type == "cpu":
        return migrate3_halo_reference(scode, fields, fills), mov_of
    out = _launch(_halo_launcher(), scode, fields, fills, ext_rows - 2, c, "migrate3 halo kernel")
    HALO_LAUNCHES += 1
    return out, mov_of


def _mov_of(scode: torch.Tensor, k_mov: Optional[int]) -> torch.Tensor:
    if k_mov is not None and k_mov < 1:
        raise ValueError(f"k_mov must be positive, got {k_mov}")
    if k_mov is None:
        return torch.zeros((), dtype=torch.bool, device=scode.device)
    return mover_overflow(scode, k_mov)


def _launch(fn, scode, fields, fills, out_rows: int, c: int, what: str) -> torch.Tensor:
    """One launch of ``jtps_migrate3`` or ``jtps_migrate3_halo`` into a new
    (F, out_rows, cap, c * c) tensor."""
    n_fields, _, cap, plane = fields.shape
    out = torch.empty((n_fields, out_rows, cap, plane), dtype=fields.dtype, device=fields.device)
    host_fills = (ctypes.c_float * n_fields)(*fills)
    status = fn(
        scode.data_ptr(), fields.data_ptr(), out.data_ptr(), host_fills,
        n_fields, out_rows, cap, c, c, fields.device.index,
        torch.cuda.current_stream(fields.device).cuda_stream,
    )
    _build.check(status, what)
    return out
