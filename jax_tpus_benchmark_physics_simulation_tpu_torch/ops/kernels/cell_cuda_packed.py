"""Kernel B3: 2D Lennard-Jones forces on the lane-packed cell grid.

Replaces the TPU kernel ``ops/kernels/cell_pallas_packed.py:_packed_kernel``
of the JAX package (built by ``make_grid_force_kernel_packed``). It computes
B1's function (``cell_cuda``) on the layout where R consecutive cell rows
share one block: grids are ``(cps / R, cap, R * cps)`` float32 and slot
``(g, a, lane)`` holds slot ``a`` of cell ``(g * R + lane // cps, lane %
cps)``. The TPU's 128-lane padding is gone. The CUDA source is B1's,
``csrc/cell_force.cu`` (``cell_force_counted_kernel``); its header says what
bounds it on an H100. B3 visits particle pairs only: it takes a ``(cps,
cps)`` int32 grid of the occupied slots of each cell, which ``GridMD`` makes
once per rebuild (a cell's particles fill slots ``0 .. count-1``), and the
result is bit-equal to B1's full-capacity loop on the unpacked grids.

The partner list (:class:`PartnerList2`) of a binning holds each target's
partners within ``cutoff + skin`` (widened for float32 rounding:
``cell_cuda3.list_radius2``); B3's list form (force-only, the same kernel
with a list pointer) walks it instead of every staged candidate, bit-equal
to the counted loop while no particle has moved skin/2 since the binning.

- :func:`choose_rows_per_block`: the JAX package's packing rule, copied
  (its module imports jax), so both packages pick the same R;
- :func:`grid_force_packed_reference`: the plain PyTorch version, used for
  CPU tensors and as the kernel's reference on the card: B1's plain version
  on the grids unpacked to ``(cps, cap, cps)``;
- :func:`grid_force_packed`: the wrapper. It checks the count grid, then a
  CPU tensor takes the plain version, a CUDA tensor launches the kernel or
  raises;
- :func:`build_partner_list2` / :func:`build_partner_list2_reference`: the
  partner list of a binning (on the card one launch of
  ``cell_list_build_kernel``); :func:`grid_force_packed_list_reference`:
  the list form's plain version;
- ``LAUNCHES`` / ``ENERGY_LAUNCHES``: kernel launches of the force-only and
  the energy variant, ``LIST_LAUNCHES``: of the list form (which
  ``LAUNCHES`` counts too), ``LIST_BUILD_LAUNCHES``: of the list build;
  each counted where a wrapper launches its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from dataclasses import replace as dataclass_replace
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import (
    CellForceParams,
    _grid_partners,
    _offset_partners,
    check_grid,
    grid_force_reference,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda3 import LIST_FULL
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn

LAUNCHES = 0
ENERGY_LAUNCHES = 0
LIST_LAUNCHES = 0
LIST_BUILD_LAUNCHES = 0
# The partner list (csrc/cell_force.cu, List2): 16-bit entries offset << 7
# | slot, the offset (dx + 1) * 3 + (dy + 1) in the counted loop's order; a
# target's count LIST_FULL where its partners overflowed the capacity; the
# capacity at most 64, the build's bitmask of a cell's slots
LIST_SLOT_BITS = 7
LIST_MAX_CAP = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_rows_per_block(cps: int, max_lanes: int = 4096) -> int:
    """Packing factor for a (cps x cps) cell grid, the JAX package's rule:
    the divisor R of cps maximizing the TPU's lane utilization
    ``R*cps / round_up(R*cps, 128)`` subject to ``R*cps <= max_lanes``,
    smallest R on ties; 1 when packing would gain < 5%. (49 at cps 49, 7 at
    cps 385, 1 at cps 121.)"""
    base_u = cps / _round_up(cps, 128)
    best_r, best_u = 1, base_u
    for r in range(2, cps + 1):
        if cps % r or r * cps > max_lanes:
            continue
        u = (r * cps) / _round_up(r * cps, 128)
        if u > best_u + 1e-9:
            best_r, best_u = r, u
    if best_u < base_u + 0.05:
        return 1
    return best_r


def unpack(g: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """``(cps/R, cap, R*cps)`` packed grid -> ``(cps, cap, cps)``, a copy
    unless R = 1."""
    if rows_per_block == 1:
        return g
    n_blocks, cap, lanes = g.shape
    cps = lanes // rows_per_block
    return g.view(n_blocks, cap, rows_per_block, cps).permute(0, 2, 1, 3).reshape(cps, cap, cps)


def pack(g: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """The inverse of :func:`unpack`."""
    if rows_per_block == 1:
        return g
    cps, cap, _ = g.shape
    n_blocks = cps // rows_per_block
    return (g.view(n_blocks, rows_per_block, cap, cps).permute(0, 2, 1, 3)
            .reshape(n_blocks, cap, rows_per_block * cps))


def grid_force_packed_reference(
    xg: torch.Tensor, yg: torch.Tensor, p: CellForceParams, rows_per_block: int,
    with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: ``(fx, fy)``, or ``(fx, fy, e,
    w)`` with ``with_energy``, on the packed layout. The force on a slot
    does not depend on where the slots sit, so this is B1's plain version
    on the unpacked grids, packed back."""
    out = grid_force_reference(unpack(xg, rows_per_block), unpack(yg, rows_per_block), p, with_energy)
    return tuple(pack(t, rows_per_block) for t in out)


@dataclass(frozen=True)
class PartnerList2:
    """The partner list of one binning for B3 (``List2`` in
    ``csrc/cell_force.cu``), in strips of ``strip`` cells of a cell row
    (B3's blocks, ``cps * ceil(cps / strip)`` of them, row by row). A
    strip's targets, its cells in order and slots ascending, are the list's
    targets ``first[s]`` on; the card numbers the strips in the order its
    blocks ran, the plain version in strip order. ``words`` (int16):
    ``stride`` target counts (``LIST_FULL``: over ``k``), then the entries
    ``offset << 7 | slot`` in the counted loop's order, four to a group,
    ``(k / 4, stride, 4)``; a partial last group is padded with the target
    itself (offset 4, its own slot). ``stride``, a multiple of 4, is the
    room for targets."""

    words: Optional[torch.Tensor]
    first: torch.Tensor
    cps: int
    strip: int
    k: int
    stride: int

    @property
    def n_strips(self) -> int:
        return self.cps * -(-self.cps // self.strip)

    @property
    def counts(self) -> torch.Tensor:
        """``(stride,)`` int32 entry counts, ``LIST_FULL`` where full."""
        return self.words[: self.stride].to(torch.int32) & 0xFFFF

    @property
    def entries(self) -> torch.Tensor:
        """``(stride, k)`` int32 entries of each target, in order."""
        e = self.words[self.stride:].view(self.k // 4, self.stride, 4).to(torch.int32) & 0xFFFF
        return e.permute(1, 0, 2).reshape(self.stride, self.k)


def _strip_counts(counts: torch.Tensor, cap: int, strip: int) -> torch.Tensor:
    """The counts clamped to ``[0, cap]`` as ``(cps, strips a row,
    strip)``, the last strip of a row padded with zeros."""
    cps = counts.shape[0]
    nsb = -(-cps // strip)
    padded = torch.zeros((cps, nsb * strip), dtype=torch.int64, device=counts.device)
    padded[:, :cps] = counts.clamp(0, cap)
    return padded.view(cps, nsb, strip)


def _targets(counts: torch.Tensor, plist: "PartnerList2", cap: int):
    """Each target of ``plist`` (a slot below its cell's count): its flat
    index in the unpacked ``(cps, cap, cps)`` grid, its number in the list,
    and the ``(cps, cap, cps)`` occupancy."""
    cps = counts.shape[0]
    dev = counts.device
    per = _strip_counts(counts, cap, plist.strip)
    within = (torch.cumsum(per, -1) - per).view(cps, -1)[:, :cps]  # (cx, cy)
    cells = torch.arange(cps, device=dev)
    sid = cells[:, None] * per.shape[1] + (cells // plist.strip)[None]
    base = plist.first.long()[sid] + within
    a = torch.arange(cap, device=dev).view(1, cap, 1)
    occ = a < counts.clamp(0, cap)[:, None, :]
    num = base[:, None, :] + a
    flat = torch.nonzero(occ.reshape(-1)).squeeze(1)
    return flat, num.reshape(-1)[flat], occ


def build_partner_list2_reference(
    xg: torch.Tensor, yg: torch.Tensor, counts: torch.Tensor, p: CellForceParams, rows_per_block: int,
    rlist2: float, k: int, stride: int, strip: int,
) -> Tuple[PartnerList2, torch.Tensor]:
    """Plain PyTorch version of the list build in strips of ``strip``
    cells, numbered in order: ``(list, full)``, ``full`` the 0-d int32
    count of targets marked full. Each target keeps the candidates of the
    counted loop, in its order, whose float32 ``r2`` is not ``>= rlist2``,
    itself excepted."""
    cps, cap = p.cps, p.cap
    dev = xg.device
    xu, yu = unpack(xg, rows_per_block), unpack(yg, rows_per_block)
    totals = _strip_counts(counts, cap, strip).sum(-1).reshape(-1)
    first = (torch.cumsum(totals, 0) - totals).to(torch.int32)
    plist = PartnerList2(None, first, cps, strip, k, stride)
    flat, num, occ = _targets(counts, plist, cap)
    a = torch.arange(cap, device=dev)
    keep = []
    for o, (dx, dy, xp, yp) in enumerate(_offset_partners(_grid_partners(xu, yu, p), p, xu)):
        ddx = xu[:, :, None, :] - xp
        ddy = yu[:, :, None, :] - yp
        r2 = ddx * ddx + ddy * ddy
        partner_occ = torch.roll(occ, (-dx, -dy), (0, 2))[:, None]
        kept = ~(r2 >= rlist2) & occ[:, :, None, :] & partner_occ
        if o == 4:
            kept &= (a[:, None] != a[None, :])[None, :, :, None]
        keep.append(kept)
    kp = torch.stack(keep).permute(1, 2, 4, 0, 3).reshape(cps * cap * cps, 9 * cap)[flat]  # (targets, 9 cap)
    n = kp.sum(-1).to(torch.int32)
    pos = torch.cumsum(kp, -1, dtype=torch.int32) - 1
    ent = ((torch.arange(9, device=dev)[:, None] << LIST_SLOT_BITS) | a[None, :]).reshape(1, 9 * cap)
    target_slot = (flat // cps) % cap
    dense = ((4 << LIST_SLOT_BITS) | target_slot)[:, None].expand(-1, k).to(torch.int32).clone()
    sel = kp & (pos < k)
    rows = torch.arange(flat.shape[0], device=dev)[:, None].expand_as(sel)
    dense[rows[sel], pos[sel].long()] = ent.expand_as(sel)[sel].to(torch.int32)
    room = num < stride
    words = torch.zeros((stride * (k + 1),), dtype=torch.int32, device=dev)
    words[num[room]] = torch.where(n <= k, n, LIST_FULL)[room]
    groups = words[stride:].view(k // 4, stride, 4)
    groups[:, num[room]] = dense[room].view(-1, k // 4, 4).permute(1, 0, 2)
    words = torch.where(words > 0x7FFF, words - 0x10000, words).to(torch.int16)
    return dataclass_replace(plist, words=words), (n[room] > k).sum().to(torch.int32)


def _listed_pairs(plist: PartnerList2, counts: torch.Tensor, cap: int) -> torch.Tensor:
    """The ``(9, cps, cap, cap, cps)`` mask of the pairs (target slot,
    partner slot) ``plist`` keeps at each offset (all of a full target's,
    and of a target it has no room for)."""
    cps = counts.shape[0]
    dev = counts.device
    flat, num, _ = _targets(counts, plist, cap)
    mask = torch.zeros((cps * cap * cps, 9 * cap), dtype=torch.bool, device=dev)
    room = num < plist.stride
    n = torch.full_like(num, LIST_FULL)
    n[room] = plist.counts[num[room]].long()
    full = n == LIST_FULL
    ent = torch.zeros((flat.shape[0], plist.k), dtype=torch.int32, device=dev)
    ent[room] = plist.entries[num[room]]
    take = torch.arange(plist.k, device=dev)[None] < torch.where(full, 0, n)[:, None]
    o, b = ent >> LIST_SLOT_BITS, ent & ((1 << LIST_SLOT_BITS) - 1)
    rows = flat[:, None].expand_as(take)
    mask[rows[take], (o * cap + b)[take].long()] = True
    mask[flat[full]] = True
    return mask.view(cps, cap, cps, 9, cap).permute(3, 0, 1, 4, 2)


def grid_force_packed_list_reference(
    xg: torch.Tensor, yg: torch.Tensor, counts: torch.Tensor, p: CellForceParams, rows_per_block: int,
    plist: PartnerList2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the list form: the plain version
    (force-only) with every pair that ``plist`` leaves out dropped (a target
    marked full keeps all its pairs). While no particle has moved skin/2
    since the binning the list was built on, each pair dropped lies beyond
    the cutoff, so this equals :func:`grid_force_packed_reference`."""
    listed = _listed_pairs(plist, counts, p.cap)
    out = grid_force_reference(unpack(xg, rows_per_block), unpack(yg, rows_per_block), p, listed=listed)
    return tuple(pack(t, rows_per_block) for t in out)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_cell_force_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 3
        + [ctypes.c_float] * 6
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _listed_launcher():
    fn = _build.library().jtps_cell_force_packed_listed
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3
        + [ctypes.c_float] * 6
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _build_launcher():
    fn = _build.library().jtps_cell_list_build
    fn.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 3
        + [ctypes.c_float] * 2
        + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(xg, yg, counts, p: CellForceParams, r: int) -> None:
    if r < 1 or p.cps % r:
        raise ValueError(f"rows_per_block {r} must divide cells_per_side {p.cps}")
    shape = (p.cps // r, p.cap, r * p.cps)
    check_grid(xg, "xg", shape, xg.device)
    check_grid(yg, "yg", shape, xg.device)
    # the kernel clamps the counts to [0, cap]; no host read of them here
    check_grid(counts, "counts", (p.cps, p.cps), xg.device, torch.int32)
    if xg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"B3 runs on cpu or cuda tensors, not {xg.device}")


def list_strip(cps: int, cap: int, device) -> int:
    """The cells a strip of B3's partner list holds: on the card the strip
    of B3's force-only blocks (``packed_strip`` in ``csrc/cell_force.cu``),
    on the CPU 32 or the row."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return _list_strip(cps, cap, dev.index or 0)
    return min(32, cps)


@functools.lru_cache(maxsize=None)
def _list_strip(cps: int, cap: int, index: int) -> int:
    fn = _build.library().jtps_cell_force_packed_strip
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    w = ctypes.c_int(0)
    _build.check(fn(cps, cap, index, ctypes.byref(w)), "cell_force_packed strip choice")
    return w.value


def build_partner_list2(
    xg: torch.Tensor, yg: torch.Tensor, counts: torch.Tensor, p: CellForceParams, rows_per_block: int,
    rlist2: float, k: int, n_targets: int, full: Optional[torch.Tensor] = None,
) -> Tuple[PartnerList2, torch.Tensor]:
    """The partner list of the binning the grids and ``counts`` hold, ``k``
    entries a target, radius^2 ``rlist2`` (``cell_cuda3.list_radius2``),
    room for ``n_targets`` targets (the particles: a target past it runs
    the counted loop). Returns ``(list, full + the targets marked full)``,
    a new 0-d int32 (``full`` None: 0). A CPU tensor takes the plain
    version, a CUDA tensor one launch of ``cell_list_build_kernel``."""
    global LIST_BUILD_LAUNCHES
    _check_inputs(xg, yg, counts, p, rows_per_block)
    dev = xg.device
    if p.cap > LIST_MAX_CAP:
        raise ValueError(f"a partner list holds cells of up to {LIST_MAX_CAP} slots, not {p.cap}")
    if k % 4 or not 0 < k < LIST_FULL:
        raise ValueError(f"k {k}: a partner list holds a positive multiple of 4 below {LIST_FULL} entries")
    if n_targets < 1:
        raise ValueError(f"n_targets {n_targets}: a partner list needs room for a target")
    stride = -(-n_targets // 4) * 4
    if full is None:
        full = torch.zeros((), dtype=torch.int32, device=dev)
    if full.dtype != torch.int32 or full.numel() != 1 or full.device != dev:
        raise TypeError(f"full: expected one int32 on {dev}, got {full.dtype} {tuple(full.shape)} on {full.device}")
    strip = list_strip(p.cps, p.cap, dev)
    if dev.type == "cpu":
        plist, n_full = build_partner_list2_reference(xg, yg, counts, p, rows_per_block, rlist2, k, stride, strip)
        return plist, full + n_full
    plist = PartnerList2(None, torch.empty((p.cps * -(-p.cps // strip),), dtype=torch.int32, device=dev), p.cps,
                         strip, k, stride)
    words = torch.empty((stride * (k + 1),), dtype=torch.int16, device=dev)
    out = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _build_launcher()(
        xg.data_ptr(), yg.data_ptr(), counts.data_ptr(), p.cps, p.cap, rows_per_block, p.box, rlist2,
        words.data_ptr(), plist.first.data_ptr(), k, stride, strip, full.data_ptr(), out.data_ptr(),
        _build.scratch_words(dev, stream).data_ptr(), dev.index, stream,
    )
    _build.check(status, "cell_list build kernel")
    LIST_BUILD_LAUNCHES += 1
    return dataclass_replace(plist, words=words), out


def grid_force_packed(
    xg: torch.Tensor, yg: torch.Tensor, counts: torch.Tensor, p: CellForceParams,
    rows_per_block: int, with_energy: bool = False, plist: Optional[PartnerList2] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(fx, fy)`` (or ``(fx, fy, e, w)``) totals on the packed grid.
    ``counts[cx, cy]`` is the number of occupied slots of cell ``(cx, cy)``,
    which must be its slots ``0 .. count-1`` (``GridMDState.counts``).
    ``plist`` (force-only): the list form, on the partner list that
    :func:`build_partner_list2` built on this binning."""
    global LAUNCHES, ENERGY_LAUNCHES, LIST_LAUNCHES
    r = rows_per_block
    _check_inputs(xg, yg, counts, p, r)
    if plist is not None:
        if with_energy:
            raise ValueError("the list form is B3's force-only variant")
        if plist.cps != p.cps or plist.words.device != xg.device:
            raise ValueError(f"plist: built for {plist.cps} cells a side on {plist.words.device}, "
                             f"not {p.cps} on {xg.device}")
    if xg.device.type == "cpu":
        if plist is not None:
            return grid_force_packed_list_reference(xg, yg, counts, p, r, plist)
        return grid_force_packed_reference(xg, yg, p, r, with_energy)
    fx = torch.empty_like(xg)
    fy = torch.empty_like(xg)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    consts = (p.cps, p.cap, r, p.box, p.cutoff2, p.sigma2, p.fscale, p.epsilon, p.shift)
    if plist is not None:
        status = _listed_launcher()(
            xg.data_ptr(), yg.data_ptr(), counts.data_ptr(), fx.data_ptr(), fy.data_ptr(), *consts,
            plist.words.data_ptr(), plist.first.data_ptr(), plist.k, plist.stride, plist.strip, xg.device.index,
            stream,
        )
        _build.check(status, "cell_force_packed list form")
        LIST_LAUNCHES += 1
        LAUNCHES += 1
        return fx, fy
    e = torch.empty_like(xg) if with_energy else None
    w = torch.empty_like(xg) if with_energy else None
    status = _launcher()(
        xg.data_ptr(), yg.data_ptr(), counts.data_ptr(), fx.data_ptr(), fy.data_ptr(),
        e.data_ptr() if with_energy else None,
        w.data_ptr() if with_energy else None,
        *consts, int(with_energy), xg.device.index, stream,
    )
    _build.check(status, "cell_force_packed kernel")
    if with_energy:
        ENERGY_LAUNCHES += 1
        return fx, fy, e, w
    LAUNCHES += 1
    return fx, fy


def make_grid_force_kernel_packed(
    grid_fn: CellGridFn, rows_per_block: int, sigma: float = 1.0, epsilon: float = 1.0,
    with_energy: bool = False,
):
    """``(xg, yg, counts) -> (fx, fy)`` (or ``(fx, fy, e, w)``) on the
    packed layout, the counterpart of the JAX package's
    ``cell_pallas_packed.make_grid_force_kernel_packed``."""
    return functools.partial(
        grid_force_packed, p=CellForceParams.from_grid(grid_fn, sigma, epsilon),
        rows_per_block=rows_per_block, with_energy=with_energy,
    )
