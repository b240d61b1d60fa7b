"""Kernels B6 and B7: the cell-grid rebuild permutation (3D) with B6's mover
flag, and B6's halo form.

Replace the TPU kernels ``ops/kernels/migrate_pallas3.py:
_migrate_kernel3_compact`` (B6, the default) and ``:_migrate_kernel3`` (B7,
``compact=False``, B6's parity oracle) of the JAX package, both built by
``make_migrate_kernel3``, and, as B6 halo, B6's explicit-halo call ``.raw``
(``migrate_pallas3.py:471``) that the row-sharded engine runs on each
device's x-rows. On the card each is one launch of one kernel
(``csrc/migrate3.cu``) that fills, scatters and raises the mover flag; its
header says why the TPU's mover compaction buys nothing there and what
bounds the kernel on an H100.

``scode`` is the (ncx, cap, ncy * ncz) int32 source-frame code grid from
``GridMD3._migration_dest``: ``dcode * cap + a`` for a slot moving in
direction ``dcode = ((dx+1)*3 + (dy+1))*3 + (dz+1)`` to slot ``a`` of its
target cell, -1 for an empty or invalid slot. ``planes`` is a sequence of F
(ncx, cap, ncy * ncz) float32 field planes, read where they lie, or one
stacked (F, ncx, cap, ncy * ncz) tensor, addressed from its base
(:mod:`._planes`); the output is one (F,
ncx, cap, ncy * ncz) tensor. ``occ`` is the allocation's occupancy of the
output (1.0 where a source lands, 0.0 elsewhere: ``_migration_dest``'s
``occ_new``): the kernel fills the slots it leaves empty.

- :func:`migrate3_reference`: the plain PyTorch version;
- :func:`mover_overflow`: B6's mover flag in plain PyTorch, computed from
  the codes as the JAX package's ``compact_fields`` does; the CPU path's,
  and the kernel's reference. The JAX package drops the movers past
  ``k_mov`` where it rises; the port moves them all, so ``GridMD3`` counts
  the rebuilds it rises in (``mover_flags``) and does not raise
  ``overflow`` for it;
- :func:`migrate3`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- :func:`migrate3_halo_reference` / :func:`migrate3_halo`: B6 halo on one
  rank's ``rows`` x-rows; ``scode`` and ``planes`` carry one halo x-row on
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

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build, _planes

LAUNCHES = 0
FLAT_LAUNCHES = 0
HALO_LAUNCHES = 0
MAX_FIELDS = 16  # kMaxFields in csrc/migrate3.cu
STAY = 13  # dcode of (dx, dy, dz) == (0, 0, 0)


def _targets3(scode: torch.Tensor, rows: int, halo: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(src, tgt)``: the flat source slots of ``scode`` (``(rows + 2, ...)``
    with ``halo``) whose valid code names a slot of the ``rows`` output
    rows, and the flat output slots they name."""
    cap, plane = scode.shape[1], scode.shape[2]
    c = math.isqrt(plane)
    code = scode.reshape(-1)
    src = torch.arange(code.numel(), device=code.device)
    dcode = torch.div(code, cap, rounding_mode="floor")
    tx = torch.div(src, cap * plane, rounding_mode="floor") + torch.div(dcode, 9, rounding_mode="floor") - 1
    ok = (code >= 0) & (code < 27 * cap)
    if halo:
        tx = tx - 1  # extended row + dx - 1: the local target row
        ok = ok & (tx >= 0) & (tx < rows)
    else:
        tx = tx % rows
    src, code, dcode, tx = src[ok], code[ok], dcode[ok], tx[ok]
    lane = src % plane
    ty = (torch.div(lane, c, rounding_mode="floor") + torch.div(dcode, 3, rounding_mode="floor") % 3 - 1) % c
    tz = (lane % c + dcode % 3 - 1) % c
    return src, (tx * cap + code % cap) * plane + ty * c + tz


def _permute(scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float], rows: int, halo: bool):
    n_fields, _, cap, plane = fields.shape
    fill = torch.tensor(list(fills), dtype=fields.dtype, device=fields.device)
    out = fill.view(n_fields, 1).expand(n_fields, rows * cap * plane).clone()
    src, tgt = _targets3(scode, rows, halo)
    out[:, tgt] = fields.reshape(n_fields, -1)[:, src]
    return out.view(n_fields, rows, cap, plane)


def migrate3_reference(
    scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float]
) -> torch.Tensor:
    """Plain PyTorch version: ``out[f, target(s)] = fields[f, s]`` for every
    source slot ``s`` with a valid code, ``fills[f]`` everywhere else."""
    return _permute(scode, fields, fills, fields.shape[1], halo=False)


def migrate3_halo_reference(scode: torch.Tensor, fields: torch.Tensor, fills: Sequence[float]) -> torch.Tensor:
    """Plain PyTorch version of B6 halo: ``out[f, target(s)] = fields[f, s]``
    for every source slot ``s`` of the extended x-rows whose valid code
    names a slot in the local rows, ``fills[f]`` everywhere else."""
    return _permute(scode, fields, fills, fields.shape[1] - 2, halo=True)


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
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
    ] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(scode: torch.Tensor, planes: _planes.Planes, fills: Sequence[float], occ: torch.Tensor,
           rows: int, what: str) -> int:
    """Checks ``scode`` (int32, ``(rows + 2 * halo, cap, c*c)``), the F field
    planes (float32, the code grid's shape; :mod:`._planes` takes their two
    forms), ``occ`` (float32, ``(rows, cap, c*c)``), all contiguous on one
    cpu or cuda device, and one fill a field; ``what`` names the source rows
    in messages. Returns F."""
    if scode.dtype != torch.int32:
        raise TypeError(f"expected int32 scode, got {scode.dtype}")
    shape = tuple(scode.shape)
    c = math.isqrt(shape[2]) if len(shape) == 3 else 0
    n_fields = len(planes)
    if not n_fields:
        raise ValueError("planes: no field plane")
    for f, plane in _planes.shaped(planes):
        if f.dtype != torch.float32:
            raise TypeError(f"expected float32 field planes, got {f.dtype}")
        if c * c != shape[-1] or plane != shape:
            raise ValueError(f"scode {shape} and field planes {tuple(f.shape)} do not describe one cubic ({what}, "
                             "cap, ncy*ncz) grid")
        if not (f.is_contiguous() and scode.is_contiguous()):
            raise ValueError("field planes and scode must be contiguous")
        if f.device != scode.device:
            raise ValueError(f"scode on {scode.device}, field plane on {f.device}")
    if len(fills) != n_fields:
        raise ValueError(f"{len(fills)} fills for {n_fields} fields")
    if scode.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the migrate kernels run on cpu or cuda tensors, not {scode.device}")
    if scode.device.type == "cuda" and n_fields > MAX_FIELDS:
        raise ValueError(f"the migrate kernel moves at most {MAX_FIELDS} fields, got {n_fields}")
    occ_shape = (rows,) + shape[1:]
    if occ.dtype != torch.float32 or tuple(occ.shape) != occ_shape or not occ.is_contiguous():
        raise ValueError(f"occ: expected a contiguous float32 {occ_shape} grid, got {occ.dtype} "
                         f"{tuple(occ.shape)}")
    if occ.device != scode.device:
        raise ValueError(f"occ: on {occ.device}, expected {scode.device}")
    return n_fields


def _check_k_mov(k_mov: Optional[int]) -> None:
    if k_mov is not None and k_mov < 1:
        raise ValueError(f"k_mov must be positive, got {k_mov}")


def _cpu_flag(scode: torch.Tensor, k_mov: Optional[int]) -> torch.Tensor:
    if k_mov is None:
        return torch.zeros((), dtype=torch.bool, device=scode.device)
    return mover_overflow(scode, k_mov)


def _launch(scode: torch.Tensor, planes: _planes.Planes, occ: torch.Tensor, fills, k_mov, halo: bool,
            what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``jtps_migrate3`` into a new (F, rows, cap, c * c)
    output and a 0-d bool flag."""
    n_fields, device = len(planes), scode.device
    rows, cap, plane = occ.shape
    out = torch.empty((n_fields, rows, cap, plane), dtype=torch.float32, device=device)
    flag = torch.empty((), dtype=torch.bool, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    c = math.isqrt(plane)
    status = _launcher()(
        scode.data_ptr(), _planes.pointers(planes), occ.data_ptr(),
        out.data_ptr(), flag.data_ptr(), _build.scratch_words(device, stream).data_ptr(),
        (ctypes.c_float * n_fields)(*fills), n_fields, rows, cap, c, c, k_mov or 0, int(halo), device.index,
        stream,
    )
    _build.check(status, what)
    return out, flag


def migrate3(
    scode: torch.Tensor,
    planes: _planes.Planes,
    fills: Sequence[float],
    k_mov: Optional[int] = None,
    *,
    occ: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Permute the F (ncx, cap, ncy * ncz) field ``planes`` by ``scode``
    into one (F, ncx, cap, ncy * ncz) tensor; ``occ`` is the allocation's
    occupancy of the output. Returns ``(out, mov_of)``: with ``k_mov`` (B6)
    ``mov_of`` is :func:`mover_overflow`, without it (B7) always False; on
    the card a 0-d bool the kernel wrote."""
    global LAUNCHES, FLAT_LAUNCHES
    _check(scode, planes, fills, occ, scode.shape[0], "ncx")
    _check_k_mov(k_mov)
    if scode.device.type == "cpu":
        return migrate3_reference(scode, _planes.stacked(planes), fills), _cpu_flag(scode, k_mov)
    out, flag = _launch(scode, planes, occ, fills, k_mov, False, "migrate3 kernel")
    if k_mov is None:
        FLAT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out, flag


def migrate3_halo(
    scode: torch.Tensor,
    planes: _planes.Planes,
    fills: Sequence[float],
    k_mov: Optional[int] = None,
    *,
    occ: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 halo: permute the (rows + 2, cap, ncy * ncz) field ``planes``
    (one halo x-row on each side, as ``scode``) into the (F, rows, cap,
    ncy * ncz) local rows; ``occ`` is the local rows' allocated occupancy.
    Returns ``(out, mov_of)``, ``mov_of`` of the local rows' codes."""
    global HALO_LAUNCHES
    rows = scode.shape[0] - 2
    if scode.dim() != 3 or rows < 1:
        raise ValueError(f"scode {tuple(scode.shape)}: expected (rows + 2, cap, c*c) with rows >= 1")
    _check(scode, planes, fills, occ, rows, "rows + 2")
    _check_k_mov(k_mov)
    if scode.device.type == "cpu":
        return migrate3_halo_reference(scode, _planes.stacked(planes), fills), _cpu_flag(scode[1:-1], k_mov)
    out, flag = _launch(scode, planes, occ, fills, k_mov, True, "migrate3 halo kernel")
    HALO_LAUNCHES += 1
    return out, flag
