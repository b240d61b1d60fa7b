"""A1: the sort-free rebuild's allocation over the 3^D migration classes.

Replaces no TPU kernel: the JAX package's allocation is jnp code that XLA
fuses (``ops/kernels/grid_md.py:253`` ``_migration_dest``,
``grid_md3.py:308`` ``_migration_dest3``). Eager PyTorch ran it as ~100
launches a 3D rebuild over (3^D, rows, cap, plane) class tensors. On the
card it is three kernel passes of ``csrc/alloc.cu``, whose header gives
each pass, why the codes are the same integers and what bounds it on an
H100 (bytes: ~240 MB a rebuild at in.lj's 4.67M slots).

The allocation gives every occupied slot a source-frame code ``dcode * cap
+ target_a``: ``dcode`` its migration class (the direction it moved in,
row-major over ``(-1, 0, 1)^D``; a particle that moved further than one
cell stays in the stayers' class and raises ``overflow``), ``target_a`` its
slot in the target cell, where the classes land in class order, each after
the counts of the classes before it. A slot whose target cell is full gets
-1 and raises ``overflow``. It also wraps the coordinates into [0, box),
and gives the new occupancy (1 on the slots below each cell's count) and
the ``(rows, plane)`` int32 count grid.

The grids are ``(rows / R, cap, R * plane)`` in the state's layout (R =
``rows_per_block`` rows a block, ``plane = cps^(D-1)``), holding the cell
rows ``row0 .. row0 + rows - 1`` of the ``cps`` a side. ``row_ext(t, dim)``
extends a per-cell array by one row at each end along ``dim``: the
periodic neighbours on one engine, the neighbour ranks' rows in the
row-sharded engines (``GridEngine._row_ext``).

- :func:`allocation_reference`: the plain PyTorch version, the eager
  allocation; the CPU's path and the kernels' reference on the card;
- :func:`allocate`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the three passes or raises;
- ``LAUNCHES``: allocations run on the card (three launches each).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Callable, Sequence, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda_packed import pack, unpack

LAUNCHES = 0
CLASS_BITS = 5  # kClassBits in csrc/alloc.cu: a K1 word is rank << CLASS_BITS | class
_MAX_DIM = 3  # kMaxDim

RowExt = Callable[[torch.Tensor, int], torch.Tensor]


@functools.lru_cache(maxsize=16)
def roll_cells_index(cps: int, rows: int, d: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat gather indices from a (3^D, rows + 2, plane) per-cell array
    (the held rows with one row past each end, ``row_ext``) into the
    (3^D, rows, plane) one: the first rolls class j's cells forward by
    its direction (``out[j, X] = v[j, X - d_j]``), the second back
    (``out[j, X] = v[j, X + d_j]``), the in-plane axes periodically. One
    gather replaces the JAX package's 3^D rolls (``roll_cells``) and
    gives the same integers."""
    c, plane = cps, cps ** (d - 1)
    dirs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=d)), device=device)
    k = dirs.shape[0]
    axes = [torch.arange(rows, device=device)] + [torch.arange(c, device=device)] * (d - 1)
    xyz = torch.stack(torch.meshgrid(*axes, indexing="ij"))[None]  # (1, D, rows, c, ...)
    dirs = dirs.view((k, d) + (1,) * d)
    j = torch.arange(k, device=device).view((k,) + (1,) * d) * ((rows + 2) * plane)

    def flat(p):
        # x is row 1 + X -+ dx of the extended rows; the plane wraps
        out = j + (1 + p[:, 0]) * plane
        for a in range(1, d):
            out = out + (p[:, a] % c) * c ** (d - 1 - a)
        return out

    return flat(xyz - dirs).reshape(-1), flat(xyz + dirs).reshape(-1)


def allocation_reference(pos: Sequence[torch.Tensor], occ: torch.Tensor, overflow: torch.Tensor, *, cps: int,
                         box: float, rows_per_block: int = 1, row0: int = 0, row_ext: RowExt):
    """Plain PyTorch version: ``(*wrapped, scode, occ_new, overflow,
    counts)`` (module docstring), the engines' eager allocation. It runs on
    the unpacked ``(rows, cap, plane)`` view of the grids (one copy each
    way where R > 1) and gives every particle the cell and slot the JAX
    package's allocation gives it: class by class in the same order, so
    the codes are the same integers."""
    d = len(pos)
    r = rows_per_block
    cap, plane = pos[0].shape[1], cps ** (d - 1)
    rows = pos[0].shape[0] * r
    dev = pos[0].device
    i32 = torch.int32

    # unwrapped drift is < skin/2 since the last rebuild; sentinel slots
    # give garbage here, gated by occ_b everywhere below
    wrapped = [torch.remainder(x, box) for x in pos]
    occ_b = unpack(occ, r) > 0.5

    # each slot's cell: its row, then its column split over the plane's axes
    cell_c = [torch.arange(row0, row0 + rows, dtype=i32, device=dev).view(rows, 1, 1)]
    col = torch.arange(plane, dtype=i32, device=dev).view(1, 1, plane)
    cell_c += [torch.div(col, cps, rounding_mode="floor"), col % cps] if d == 3 else [col]
    cell = box / cps
    dirs = []
    for w, c in zip(wrapped, cell_c):
        t = torch.div(unpack(w, r), cell, rounding_mode="floor").to(i32).clamp(0, cps - 1)
        dirs.append((t - c + 1 + cps) % cps - 1)  # migration direction in {-1, 0, 1}, periodic
    far = dirs[0].abs() > 1
    for dk in dirs[1:]:
        far = far | (dk.abs() > 1)
    moved_far = occ_b & far
    overflow = overflow | torch.any(moved_far)
    # a far-mover (flagged above) stays in its source cell
    dirs = [torch.where(moved_far, 0, dk) for dk in dirs]

    # Allocation: per target cell, the classes (stayers and each
    # direction) land in fixed order, each class's slots starting after
    # the counts of all earlier classes. A target receives movers of
    # direction d from exactly one source cell (t - d), so a mover's
    # in-class rank at the target is its rank within its source cell.
    dcode = dirs[0] + 1
    for dk in dirs[1:]:
        dcode = dcode * 3 + (dk + 1)  # class in 0 .. 3^D - 1
    k = 3**d
    dm = (torch.arange(k, dtype=i32, device=dev).view(k, 1, 1, 1) == dcode[None]) & occ_b[None]
    dmi = dm.to(i32)
    inc = torch.cumsum(dmi, dim=2, dtype=i32)  # along the slot axis
    ranks = inc - dmi  # exclusive in-cell rank within the class
    counts = row_ext(inc[:, :, cap - 1, :], 1)  # (k, rows + 2, plane)
    fwd, back = roll_cells_index(cps, rows, d, str(dev))
    # per-class counts at the TARGET cell, exclusive-prefixed in class
    # order: the first free slot before each class arrives
    rc = counts.reshape(-1)[fwd].view(k, rows, 1, plane)
    bases_t = torch.cumsum(rc, dim=0, dtype=i32) - rc
    base_src = row_ext(bases_t, 1).reshape(-1)[back].view(k, rows, 1, plane)
    picked = torch.where(dm, base_src + ranks, 0).sum(0, dtype=i32)
    target_a = torch.where(occ_b, picked, -1)

    overflow = overflow | torch.any((target_a >= cap) & occ_b)
    valid = occ_b & (target_a >= 0) & (target_a < cap)
    # classes occupy disjoint code ranges [j*cap, (j+1)*cap)
    scode = torch.where(valid, dcode * cap + target_a, -1).to(i32)

    # post-rebuild occupancy: slots fill compactly from 0
    tot = torch.clamp(rc.sum(0, dtype=i32), max=cap)  # (rows, 1, plane)
    slot_i = torch.arange(cap, dtype=i32, device=dev).view(1, cap, 1)
    occ_new = (slot_i < tot).to(occ.dtype)
    return (*wrapped, pack(scode, r), pack(occ_new, r), overflow, tot.view(rows, plane))


def _check(pos: Sequence[torch.Tensor], occ: torch.Tensor, overflow: torch.Tensor, cps: int, rows_per_block: int,
           row0: int) -> None:
    d = len(pos)
    if not 2 <= d <= _MAX_DIM:
        raise ValueError(f"pos: expected 2 or 3 coordinate planes, got {d}")
    like = pos[0]
    if like.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the allocation runs on cpu or cuda tensors, not {like.device}")
    if like.dim() != 3:
        raise ValueError(f"pos: expected (blocks, cap, lanes) planes, got shape {tuple(like.shape)}")
    for name, t in [("pos", p) for p in pos] + [("occ", occ)]:
        if t.device != like.device or t.shape != like.shape:
            raise ValueError(f"{name}: a plane of shape {tuple(t.shape)} on {t.device}, expected "
                             f"{tuple(like.shape)} on {like.device}")
        if not t.dtype.is_floating_point or t.dtype != like.dtype:
            raise TypeError(f"{name}: a {t.dtype} plane, expected the coordinates' floating-point dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous planes")
    if like.device.type == "cuda" and like.dtype != torch.float32:
        raise TypeError(f"the allocation kernels take float32 planes, got {like.dtype}")
    if overflow.dtype != torch.bool or overflow.dim() != 0 or overflow.device != like.device:
        raise ValueError(f"overflow: expected a 0-d bool on {like.device}, got {overflow.dtype} "
                         f"{tuple(overflow.shape)} on {overflow.device}")
    n_blocks, _, lanes = like.shape
    plane = cps ** (d - 1)
    if rows_per_block < 1 or lanes != rows_per_block * plane:
        raise ValueError(f"lanes {lanes}: expected rows_per_block {rows_per_block} x {plane} cells of a {d}D row "
                         f"at cps {cps}")
    if row0 < 0 or row0 + n_blocks * rows_per_block > cps:
        raise ValueError(f"rows {row0} .. {row0 + n_blocks * rows_per_block - 1} do not lie in the {cps} a side")


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = _build.library()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    planes = ctypes.POINTER(ctypes.c_void_p)
    classes = lib.jtps_alloc_classes
    classes.argtypes = [i32, planes, ptr, planes, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, f32, i32, ptr]
    bases = lib.jtps_alloc_bases
    bases.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    codes = lib.jtps_alloc_codes
    codes.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    for fn in (classes, bases, codes):
        fn.restype = ctypes.c_int
    return classes, bases, codes


def _pointers(planes: Sequence[torch.Tensor]) -> ctypes.Array:
    got = [p.data_ptr() for p in planes]
    return (ctypes.c_void_p * _MAX_DIM)(*got, *[None] * (_MAX_DIM - len(got)))


def _extended(t: torch.Tensor, row_ext: RowExt, name: str) -> torch.Tensor:
    """``row_ext(t, 1)``, checked: one row more at each end, contiguous."""
    out = row_ext(t, 1)
    want = (t.shape[0], t.shape[1] + 2, t.shape[2])
    if tuple(out.shape) != want or out.dtype != t.dtype or out.device != t.device or not out.is_contiguous():
        raise ValueError(f"row_ext({name}): expected a contiguous {t.dtype} {want} on {t.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def _launch(pos, occ, overflow, cps: int, box: float, r: int, row0: int, row_ext: RowExt):
    d = len(pos)
    n_blocks, cap, lanes = pos[0].shape
    plane = lanes // r
    rows = n_blocks * r
    dev = pos[0].device
    i32 = torch.int32
    stream = torch.cuda.current_stream(dev).cuda_stream
    geo = (n_blocks, cap, lanes, plane, cps)
    classes, bases_fn, codes = _launchers()
    wrapped = [torch.empty_like(p) for p in pos]
    code = torch.empty(pos[0].shape, dtype=i32, device=dev)
    counts = torch.empty((3**d, rows, plane), dtype=i32, device=dev)
    flag = torch.empty((), dtype=torch.bool, device=dev)
    _build.check(classes(d, _pointers(pos), occ.data_ptr(), _pointers(wrapped), code.data_ptr(), counts.data_ptr(),
                         flag.data_ptr(), *geo, row0, box, box / cps, dev.index, stream), "allocation classes kernel")
    counts_ext = _extended(counts, row_ext, "counts")
    bases = torch.empty_like(counts)
    tot = torch.empty((rows, plane), dtype=i32, device=dev)
    occ_new = torch.empty_like(occ)
    _build.check(bases_fn(d, counts_ext.data_ptr(), overflow.data_ptr(), flag.data_ptr(), bases.data_ptr(),
                          tot.data_ptr(), occ_new.data_ptr(), *geo, dev.index, stream), "allocation bases kernel")
    bases_ext = _extended(bases, row_ext, "bases")
    _build.check(codes(d, bases_ext.data_ptr(), code.data_ptr(), flag.data_ptr(), *geo, dev.index, stream),
                 "allocation codes kernel")
    return (*wrapped, code, occ_new, flag, tot)


def allocate(pos: Sequence[torch.Tensor], occ: torch.Tensor, overflow: torch.Tensor, *, cps: int, box: float,
             rows_per_block: int = 1, row0: int = 0, row_ext: RowExt):
    """The allocation of the coordinate planes ``pos`` (one an axis) and
    the occupancy ``occ``, in the state's layout, with the state's
    ``overflow`` (a 0-d bool): ``(*wrapped, scode, occ_new, overflow,
    counts)`` (module docstring). A CPU tensor takes
    :func:`allocation_reference`; float32 CUDA tensors run the three
    passes of ``csrc/alloc.cu``, whose outputs are the plain version's
    bits."""
    global LAUNCHES
    pos = list(pos)
    _check(pos, occ, overflow, cps, rows_per_block, row0)
    kw = dict(cps=cps, box=box, rows_per_block=rows_per_block, row0=row0, row_ext=row_ext)
    if pos[0].device.type == "cpu":
        return allocation_reference(pos, occ, overflow, **kw)
    out = _launch(pos, occ, overflow, cps, box, rows_per_block, row0, row_ext)
    LAUNCHES += 1
    return out
