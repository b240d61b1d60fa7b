"""Kernel B2: the cell-grid rebuild permutation (2D), and its halo form.

Replaces the TPU kernel ``ops/kernels/migrate_pallas.py:_migrate_kernel`` of
the JAX package (built by ``make_migrate_kernel``) and, as B2 halo, its
explicit-halo call ``.raw`` (``migrate_pallas.py:226``, R = 1) that the
row-sharded engine runs on each device's rows. The CUDA source is
``csrc/migrate.cu``; its header says what bounds it on an H100 (at N=100k
with Kahan fields, 11 planes of 234k slots: a few microseconds of HBM
traffic) and why a direct scatter replaces the TPU's 9*cap-candidate
compare/select.

``scode`` is the (G, cap, R * cps) int32 source-frame code grid from
``GridMD._migration_dest``: ``dcode * cap + a`` for a slot moving in
direction ``dcode = (dx+1)*3 + (dy+1)`` to slot ``a`` of its target cell,
-1 for an empty or invalid slot. ``fields`` is one stacked
(F, G, cap, R * cps) float32 tensor, so one launch moves every field. R
(``rows_per_block``) cell rows share a block, G = cps / R; R = 1 is the
unpacked (cps, cap, cps) layout, R > 1 the packed layout of kernel B3
(``cell_cuda_packed``), where the JAX kernel patches the block-crossing
rows (``migrate_pallas._row_source``) and the port's index map does it.

- :func:`migrate_reference`: the plain PyTorch version;
- :func:`migrate`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- :func:`migrate_halo_reference` / :func:`migrate_halo`: B2 halo on one
  rank's ``rows`` cell rows. ``scode`` and ``fields`` carry one halo row on
  each side, ``(rows + 2, cap, cps)``, the output only the local rows; a
  source whose target row lies outside them is dropped (the rank that owns
  that row moves it from its own halo copy);
- ``LAUNCHES`` / ``PACKED_LAUNCHES`` / ``HALO_LAUNCHES``: kernel launches on
  the unpacked and on the packed layout and of B2 halo, counted where the
  wrappers launch them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

LAUNCHES = 0
PACKED_LAUNCHES = 0
HALO_LAUNCHES = 0
MAX_FIELDS = 16  # kMaxFields in csrc/migrate.cu


def migrate_reference(
    scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float], rows_per_block: int = 1
) -> torch.Tensor:
    """Plain PyTorch version: ``out[f, target(s)] = fields[f, s]`` for every
    source slot ``s`` with a valid code, ``fills[f]`` everywhere else."""
    n_fields, n_blocks, cap, lanes = fields.shape
    r = rows_per_block
    cps = lanes // r
    fill = torch.tensor(list(fills), dtype=fields.dtype, device=fields.device)
    out = fill.view(n_fields, 1).expand(n_fields, n_blocks * cap * lanes).clone()
    code = scode.reshape(-1)
    src = torch.arange(code.numel(), device=code.device)
    ok = (code >= 0) & (code < 9 * cap)
    src = src[ok]
    code = code[ok]
    dcode = torch.div(code, cap, rounding_mode="floor")
    a = code % cap
    lane = src % lanes
    cx = torch.div(src, cap * lanes, rounding_mode="floor") * r + torch.div(lane, cps, rounding_mode="floor")
    tx = (cx + torch.div(dcode, 3, rounding_mode="floor") - 1) % cps
    ty = (lane % cps + dcode % 3 - 1) % cps
    tgt = (torch.div(tx, r, rounding_mode="floor") * cap + a) * lanes + (tx % r) * cps + ty
    out[:, tgt] = fields.reshape(n_fields, -1)[:, src]
    return out.view(n_fields, n_blocks, cap, lanes)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_migrate
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def migrate_halo_reference(scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of B2 halo: ``out[f, target(s)] = fields[f, s]``
    for every source slot ``s`` of the extended rows whose valid code names
    a slot in the local rows, ``fills[f]`` everywhere else."""
    n_fields, ext_rows, cap, cps = fields.shape
    rows = ext_rows - 2
    fill = torch.tensor(list(fills), dtype=fields.dtype, device=fields.device)
    out = fill.view(n_fields, 1).expand(n_fields, rows * cap * cps).clone()
    code = scode.reshape(-1)
    src = torch.arange(code.numel(), device=code.device)
    dcode = torch.div(code, cap, rounding_mode="floor")
    # extended row + dx - 1: the local target row
    tx = torch.div(src, cap * cps, rounding_mode="floor") + torch.div(dcode, 3, rounding_mode="floor") - 2
    ok = (code >= 0) & (code < 9 * cap) & (tx >= 0) & (tx < rows)
    src, code, dcode, tx = src[ok], code[ok], dcode[ok], tx[ok]
    ty = (src % cps + dcode % 3 - 1) % cps
    tgt = (tx * cap + code % cap) * cps + ty
    out[:, tgt] = fields.reshape(n_fields, -1)[:, src]
    return out.view(n_fields, rows, cap, cps)


def check_migrate_args(scode, fields, fills, max_fields: int) -> None:
    """Raise unless ``scode`` (int32) and the stacked ``fields`` (float32)
    are contiguous on one device with one fill per field."""
    if fields.dtype != torch.float32 or scode.dtype != torch.int32:
        raise TypeError(f"expected float32 fields and int32 scode, got {fields.dtype}, {scode.dtype}")
    if not (fields.is_contiguous() and scode.is_contiguous()):
        raise ValueError("fields and scode must be contiguous")
    if scode.device != fields.device:
        raise ValueError(f"scode on {scode.device}, fields on {fields.device}")
    if len(fills) != fields.shape[0]:
        raise ValueError(f"{len(fills)} fills for {fields.shape[0]} fields")
    if fields.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the migrate kernels run on cpu or cuda tensors, not {fields.device}")
    if fields.device.type == "cuda" and fields.shape[0] > max_fields:
        raise ValueError(f"the migrate kernel moves at most {max_fields} fields, got {fields.shape[0]}")


@functools.lru_cache(maxsize=None)
def _halo_launcher():
    fn = _build.library().jtps_migrate_halo
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def migrate_halo(scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float]) -> torch.Tensor:
    """B2 halo: permute the stacked (F, rows + 2, cap, cps) ``fields`` by
    ``scode`` into the (F, rows, cap, cps) local rows."""
    global HALO_LAUNCHES
    if fields.dim() != 4 or fields.shape[1] < 3 or tuple(scode.shape) != tuple(fields.shape[1:]):
        raise ValueError(
            f"scode {tuple(scode.shape)} and fields {tuple(fields.shape)}: expected "
            "(rows + 2, cap, cps) and (F, rows + 2, cap, cps) with rows >= 1"
        )
    check_migrate_args(scode, fields, fills, MAX_FIELDS)
    if fields.device.type == "cpu":
        return migrate_halo_reference(scode, fields, fills)
    n_fields, ext_rows, cap, cps = fields.shape
    out = torch.empty((n_fields, ext_rows - 2, cap, cps), dtype=fields.dtype, device=fields.device)
    host_fills = (ctypes.c_float * n_fields)(*fills)
    status = _halo_launcher()(
        scode.data_ptr(), fields.data_ptr(), out.data_ptr(), host_fills,
        n_fields, ext_rows - 2, cps, cap, fields.device.index,
        torch.cuda.current_stream(fields.device).cuda_stream,
    )
    _build.check(status, "migrate halo kernel")
    HALO_LAUNCHES += 1
    return out


def migrate(
    scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float], rows_per_block: int = 1
) -> torch.Tensor:
    """Permute the stacked (F, cps / R, cap, R * cps) ``fields`` by
    ``scode``, R = ``rows_per_block``."""
    global LAUNCHES, PACKED_LAUNCHES
    if fields.dim() != 4:
        raise ValueError(f"fields: expected (F, cps/R, cap, R*cps), got {tuple(fields.shape)}")
    n_fields, n_blocks, cap, lanes = fields.shape
    r = rows_per_block
    cps = n_blocks * r
    if r < 1 or lanes != r * cps or tuple(scode.shape) != (n_blocks, cap, lanes):
        raise ValueError(
            f"scode {tuple(scode.shape)} and fields {tuple(fields.shape)} "
            f"do not describe one (cps/R, cap, R*cps) grid with R = {r}"
        )
    check_migrate_args(scode, fields, fills, MAX_FIELDS)
    if fields.device.type == "cpu":
        return migrate_reference(scode, fields, fills, r)
    out = torch.empty_like(fields)
    host_fills = (ctypes.c_float * n_fields)(*fills)
    status = _launcher()(
        scode.data_ptr(), fields.data_ptr(), out.data_ptr(), host_fills,
        n_fields, cps, cap, r, fields.device.index,
        torch.cuda.current_stream(fields.device).cuda_stream,
    )
    _build.check(status, "migrate kernel")
    if r == 1:
        LAUNCHES += 1
    else:
        PACKED_LAUNCHES += 1
    return out
