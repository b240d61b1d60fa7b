"""Kernel B2: the cell-grid rebuild permutation (2D), and its halo form.

Replaces the TPU kernel ``ops/kernels/migrate_pallas.py:_migrate_kernel`` of
the JAX package (built by ``make_migrate_kernel``) and, as B2 halo, its
explicit-halo call ``.raw`` (``migrate_pallas.py:226``, R = 1) that the
row-sharded engine runs on each device's rows. On the card each is one
launch of one kernel (``csrc/migrate.cu``) that fills and scatters; its
header says what bounds it on an H100 (at N=100k with Kahan fields, 11
planes of 234k slots: a few microseconds of HBM traffic) and why a direct
scatter replaces the TPU's 9*cap-candidate compare/select.

``scode`` is the (G, cap, R * cps) int32 source-frame code grid from
``GridMD._migration_dest``: ``dcode * cap + a`` for a slot moving in
direction ``dcode = (dx+1)*3 + (dy+1)`` to slot ``a`` of its target cell,
-1 for an empty or invalid slot. ``planes`` is a sequence of F float32 field
planes of the code grid's shape, read where they lie, or one stacked (F, G,
cap, R * cps) tensor, addressed from its base (:mod:`._planes`); the
output is one (F, G, cap, R * cps) tensor. ``occ`` is the allocation's occupancy of the output (1.0 where a
source lands, 0.0 elsewhere: ``_migration_dest``'s ``occ_new``): the kernel
fills the slots it leaves empty. R (``rows_per_block``) cell rows share a
block, G = cps / R; R = 1 is the unpacked (cps, cap, cps) layout, R > 1 the
packed layout of kernel B3 (``cell_cuda_packed``), where the JAX kernel
patches the block-crossing rows (``migrate_pallas._row_source``) and the
port's index map does it.

- :func:`migrate_reference`: the plain PyTorch version; it fills every slot
  that no code names, without ``occ``;
- :func:`migrate`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- :func:`migrate_halo_reference` / :func:`migrate_halo`: B2 halo on one
  rank's ``rows`` cell rows. ``scode`` and ``planes`` carry one halo row on
  each side, ``(rows + 2, cap, cps)``, ``occ`` and the output only the local
  rows; a source whose target row lies outside them is dropped (the rank
  that owns that row moves it from its own halo copy);
- ``LAUNCHES`` / ``PACKED_LAUNCHES`` / ``HALO_LAUNCHES``: kernel launches on
  the unpacked and on the packed layout and of B2 halo, counted where the
  wrappers launch them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build, _planes

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


@functools.lru_cache(maxsize=None)
def _launchers():
    """``(jtps_migrate, jtps_migrate_halo)`` with their argument types."""
    lib = _build.library()
    head = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float)]
    for fn in (lib.jtps_migrate, lib.jtps_migrate_halo):
        fn.argtypes = head + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib.jtps_migrate, lib.jtps_migrate_halo


def _check(scode: torch.Tensor, planes: _planes.Planes, fills: Sequence[float], occ: torch.Tensor,
           occ_shape: Tuple[int, ...]) -> int:
    """Checks ``scode`` (int32), the F field planes (float32, the code
    grid's shape; :mod:`._planes` takes their two forms), ``occ`` (float32,
    ``occ_shape``), all contiguous on one cpu or cuda device, and one fill a
    field. Returns F."""
    if scode.dtype != torch.int32:
        raise TypeError(f"expected int32 scode, got {scode.dtype}")
    for f, plane in _planes.shaped(planes):
        if f.dtype != torch.float32:
            raise TypeError(f"expected float32 field planes, got {f.dtype}")
        if plane != tuple(scode.shape):
            raise ValueError(f"field planes {tuple(f.shape)}: expected the code grid's {tuple(scode.shape)}")
        if not (f.is_contiguous() and scode.is_contiguous()):
            raise ValueError("field planes and scode must be contiguous")
        if f.device != scode.device:
            raise ValueError(f"scode on {scode.device}, field plane on {f.device}")
    n_fields = len(planes)
    if not n_fields:
        raise ValueError("planes: no field plane")
    if len(fills) != n_fields:
        raise ValueError(f"{len(fills)} fills for {n_fields} fields")
    if scode.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the migrate kernels run on cpu or cuda tensors, not {scode.device}")
    if scode.device.type == "cuda" and n_fields > MAX_FIELDS:
        raise ValueError(f"the migrate kernel moves at most {MAX_FIELDS} fields, got {n_fields}")
    if occ.dtype != torch.float32 or tuple(occ.shape) != occ_shape or not occ.is_contiguous():
        raise ValueError(f"occ: expected a contiguous float32 {occ_shape} grid, got {occ.dtype} "
                         f"{tuple(occ.shape)}")
    if occ.device != scode.device:
        raise ValueError(f"occ: on {occ.device}, expected {scode.device}")
    return n_fields


def _launch(fn, scode: torch.Tensor, planes: _planes.Planes, n_fields: int, occ: torch.Tensor, fills, dims,
            what: str):
    """One launch of ``fn`` (``jtps_migrate`` or ``jtps_migrate_halo``, whose
    three int arguments after the field count are ``dims``) into a new
    (F, *occ.shape) output."""
    device = scode.device
    out = torch.empty((n_fields,) + tuple(occ.shape), dtype=torch.float32, device=device)
    status = fn(
        scode.data_ptr(), _planes.pointers(planes), occ.data_ptr(), out.data_ptr(),
        (ctypes.c_float * n_fields)(*fills), n_fields, *dims, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(status, what)
    return out


def migrate(
    scode: torch.Tensor,
    planes: _planes.Planes,
    fills: Sequence[float],
    rows_per_block: int = 1,
    *,
    occ: torch.Tensor,
) -> torch.Tensor:
    """Permute the F (cps / R, cap, R * cps) field ``planes`` by ``scode``
    into one (F, cps / R, cap, R * cps) tensor, R = ``rows_per_block``;
    ``occ`` is the allocation's occupancy of the output."""
    global LAUNCHES, PACKED_LAUNCHES
    r = rows_per_block
    shape = tuple(scode.shape)
    if r < 1 or len(shape) != 3 or shape[2] != r * r * shape[0]:
        raise ValueError(f"scode {shape} does not describe one (cps/R, cap, R*cps) grid with R = {r}")
    n_fields = _check(scode, planes, fills, occ, shape)
    if scode.device.type == "cpu":
        return migrate_reference(scode, _planes.stacked(planes), fills, r)
    n_blocks, cap, _ = shape
    out = _launch(_launchers()[0], scode, planes, n_fields, occ, fills, (n_blocks * r, cap, r), "migrate kernel")
    if r == 1:
        LAUNCHES += 1
    else:
        PACKED_LAUNCHES += 1
    return out


def migrate_halo(
    scode: torch.Tensor, planes: _planes.Planes, fills: Sequence[float], *, occ: torch.Tensor
) -> torch.Tensor:
    """B2 halo: permute the (rows + 2, cap, cps) field ``planes`` (one halo
    row on each side, as ``scode``) into the (F, rows, cap, cps) local rows;
    ``occ`` is the local rows' allocated occupancy."""
    global HALO_LAUNCHES
    shape = tuple(scode.shape)
    if len(shape) != 3 or shape[0] < 3:
        raise ValueError(f"scode {shape}: expected (rows + 2, cap, cps) with rows >= 1")
    rows, cap, cps = shape[0] - 2, shape[1], shape[2]
    n_fields = _check(scode, planes, fills, occ, (rows, cap, cps))
    if scode.device.type == "cpu":
        return migrate_halo_reference(scode, _planes.stacked(planes), fills)
    out = _launch(_launchers()[1], scode, planes, n_fields, occ, fills, (rows, cps, cap), "migrate halo kernel")
    HALO_LAUNCHES += 1
    return out
