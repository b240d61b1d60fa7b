"""Kernels B4 and B5: 3D Lennard-Jones forces on the cell grid, and their
halo forms.

Replace the TPU kernels ``ops/kernels/cell_pallas3.py:_newton_kernel3``
(B4, partner slots bounded at run time by the max cell occupancy) and
``:_static_kernel3`` (B5, the bound ``cov`` fixed at compile time) of the
JAX package, both built by ``make_grid_force_kernel3``, and, as B4/B5
halo, their explicit-halo call ``.raw`` (``cell_pallas3.py:722``) that the
row-sharded engine runs on each device's x-rows. The CUDA source is ``csrc/cell_force3.cu``. Both are the
counted kernel (``cell_force3_counted_kernel<COV, ...>``): one block a
strip of z-cells, the 3 x 3 neighbour lines staged in shared memory with
occupied slots only, one thread per occupied target. B5 is it at
``COV = cov``; B4 at ``COV = 0``, its shared memory sized for the capacity
and its bound ``max_occ`` read on the card through a pointer. Each is
bit-equal to its full loop over the bound's slots
(``cell_force3_kernel<COV, ...>``), which stays in the library as its
yardstick. The source's header says what bounds them on an H100 and how
the design answers that.

Grids are ``(ncx, cap, ncy * ncz)`` float32, the (y, z) cell plane flattened
without the TPU's 128-lane padding. Empty slots hold the x sentinel
``2.5 * box`` (y = z = 0), which the validity test ``0 < r2 < cutoff^2``
rejects, so no occupancy mask is read. Slots at or past the bound get zero.
The counted kernel takes each cell's count as its number of non-sentinel
slots below the bound: the engines fill a cell's slots from 0 at every
(re)binning, and the x-rows the halo exchange attaches are such rows.

- :func:`grid_force3_reference`: the plain PyTorch version, used for CPU
  tensors and as the kernels' reference on the card;
- :func:`grid_force3`: the wrapper. A CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises;
- :func:`grid_force3_halo_reference` / :func:`grid_force3_halo`: the same
  on one rank's ``rows`` x-rows with one halo x-row on each side,
  ``(rows + 2, cap, ncy * ncz)`` in and ``(rows, cap, ncy * ncz)`` out. The
  caller puts the x seam into the halo rows; x does not wrap. Over P row
  blocks the result is bit-equal to the full kernels;
- :func:`grid_force3_loop` / :func:`grid_force3_static_loop`: B4's and
  B5's full loops on the card, which no path runs: the counted kernel's
  bit-exact and timing yardsticks;
- :func:`strip_width`: the z-cells a block of the counted kernel takes (on
  the card);
- :func:`build_partner_list3` / :func:`build_partner_list3_reference`: the
  partner list of a binning (:class:`PartnerList3`), which
  ``grid_force3(..., plist=...)``, the list form of B4 and B5, walks
  instead of every staged candidate (force-only, whole grid; on the card
  the same counted kernel, ``Params::list`` set), bit-equal to the counted
  loop while no particle has moved skin/2 from the binning;
  :func:`grid_force3_list_reference` is its plain version;
- ``LAUNCHES`` / ``ENERGY_LAUNCHES``: launches of B4 and of its energy
  variant, ``COUNTED_LAUNCHES``: of B5 (the counted kernel, either
  variant), and ``HALO_LAUNCHES`` / ``HALO_ENERGY_LAUNCHES`` /
  ``HALO_COUNTED_LAUNCHES`` the same of the halo forms;
  ``LIST_LAUNCHES``: of the list form (B4's or B5's, which their own
  counters count too), ``LIST_BUILD_LAUNCHES``: of the list build;
  ``LOOP_LAUNCHES`` / ``HALO_LOOP_LAUNCHES``: of B4's loop and
  ``STATIC_LAUNCHES`` / ``HALO_STATIC_LAUNCHES``: of B5's full loop (either
  variant); each counted where a wrapper launches its kernel;
- ``MAX_CAP``: the largest capacity B4's shared memory holds.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from dataclasses import replace as dataclass_replace
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda import SENTINEL_FACTOR, check_grid
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellGridFn
# the list build's two words of last-block scratch: B6's pair for the
# (device, stream), which each launch leaves zeroed for the next
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.migrate_cuda3 import _sync_words

LAUNCHES = 0
ENERGY_LAUNCHES = 0
COUNTED_LAUNCHES = 0
HALO_LAUNCHES = 0
HALO_ENERGY_LAUNCHES = 0
HALO_COUNTED_LAUNCHES = 0
STATIC_LAUNCHES = 0
HALO_STATIC_LAUNCHES = 0
LOOP_LAUNCHES = 0
HALO_LOOP_LAUNCHES = 0
LIST_LAUNCHES = 0
LIST_BUILD_LAUNCHES = 0
# the compile-time bounds csrc/cell_force3.cu instantiates for B5
STATIC_COVS = (8, 16, 24, 32, 40, 48, 56, 64)
MAX_STRIP = 32  # z-cells of a counted block: one warp's prefix sum
# B4's largest capacity: the largest multiple of 8 whose strip of one
# z-cell, with the energy, fits the H100's 232,448 bytes of shared memory
# a block (Strip3::bytes in csrc/cell_force3.cu: 345 * cap + 440)
MAX_CAP = 672
# The partner list (csrc/cell_force3.cu, PartnerList): 16-bit entries
# staged cell << 7 | slot, a target's count LIST_FULL where its partners
# overflowed the capacity; the bound is at most 64, the build's bitmask of
# an offset's slots (the slot field holds it and the pad entry's far slot)
LIST_FULL = 0xFFFF
LIST_SLOT_BITS = 7
LIST_MAX_BOUND = 64
# the steps after its binning that a partner list serves at most: its
# radius covers float32 coordinates rounded that many times (list_radius2);
# the engine's windows past it run the counted loop
LIST_STEPS = 64


@dataclass(frozen=True)
class CellForce3Params:
    """Grid shape and LJ constants of one 3D force kernel (cubic grid:
    ``ncx = ncy = ncz = cps``)."""

    cps: int
    cap: int
    box: float
    cutoff2: float
    sigma2: float
    epsilon: float
    shift: float  # U(cutoff), subtracted from every pair energy

    @property
    def fscale(self) -> float:
        return 24.0 * self.epsilon / self.sigma2

    @property
    def sentinel(self) -> float:
        return SENTINEL_FACTOR * self.box

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (self.cps, self.cap, self.cps * self.cps)

    @classmethod
    def from_grid(cls, grid_fn: CellGridFn, sigma: float = 1.0, epsilon: float = 1.0):
        if grid_fn.dim != 3:
            raise ValueError("the 3D cell force kernel needs a 3D grid")
        sc6 = (sigma / grid_fn.cutoff) ** 6
        return cls(
            cps=grid_fn.cells_per_side,
            cap=grid_fn.capacity,
            box=float(grid_fn.box),
            cutoff2=float(grid_fn.cutoff) ** 2,
            sigma2=float(sigma) ** 2,
            epsilon=float(epsilon),
            shift=float(4.0 * epsilon * (sc6 * sc6 - sc6)),
        )


def grid_force3_reference(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    bound: Optional[int] = None,
    with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernels: ``(fx, fy, fz)``, or
    ``(fx, fy, fz, e, w)`` with ``with_energy``, covering slots ``< bound``
    (default: all) on both sides of a pair. For each of the 27 neighbour
    offsets the partner grid is the rolled grid plus the seam offsets (+-box
    on each axis whose cell index wraps), and the (ncx, a, b, ncy, ncz) pair
    block is summed over b. Works in any float dtype."""
    c, cap = p.cps, p.cap
    bound = cap if bound is None else min(max(int(bound), 0), cap)
    x4, y4, z4 = (g.view(c, cap, c, c)[:, :bound] for g in (xg, yg, zg))
    return _pair_sums3(x4, y4, z4, _grid_partners(x4, y4, z4, p), p, bound, with_energy)


def _grid_partners(x4, y4, z4, p: CellForce3Params):
    """``partners(dx)`` of the whole grid: the views rolled by x offset
    ``dx``, x seam added."""
    c = p.cps
    idx = torch.arange(c, device=x4.device)

    def partners(dx):
        # +box where the x index wraps past the top, -box past the bottom
        seam = ((idx + dx >= c).to(x4.dtype) - (idx + dx < 0).to(x4.dtype)) * p.box
        return torch.roll(x4, -dx, 0) + seam[:, None, None, None], torch.roll(y4, -dx, 0), torch.roll(z4, -dx, 0)

    return partners


def grid_force3_list_reference(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    plist: "PartnerList3",
    bound: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the list form: :func:`grid_force3_reference`
    (force-only) with every pair that ``plist`` leaves out dropped (a target
    marked full keeps all of its pairs). While no particle has moved skin/2
    since the binning the list was built on, each pair dropped lies beyond
    the cutoff and the result is :func:`grid_force3_reference`'s bits."""
    c, cap = p.cps, p.cap
    bound = cap if bound is None else min(max(int(bound), 0), cap)
    x4, y4, z4 = (g.view(c, cap, c, c)[:, :bound] for g in (xg, yg, zg))
    listed = _listed_pairs(plist, x4 != p.sentinel)
    return _pair_sums3(x4, y4, z4, _grid_partners(x4, y4, z4, p), p, bound, False, listed)


def grid_force3_halo_reference(
    xh: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    p: CellForce3Params,
    bound: Optional[int] = None,
    with_energy: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of B4/B5 halo: ``(rows + 2, cap, ncy*ncz)``
    grids with their halo x-rows (seam offsets included) in, the full
    kernels' outputs on the ``rows`` local rows out."""
    c, cap = p.cps, p.cap
    bound = cap if bound is None else min(max(int(bound), 0), cap)
    rows = xh.shape[0] - 2
    h4 = [g.view(rows + 2, cap, c, c)[:, :bound] for g in (xh, yh, zh)]
    return _pair_sums3(
        *(g[1:-1] for g in h4), lambda dx: tuple(g[1 + dx : 1 + dx + rows] for g in h4), p, bound, with_energy
    )


def _pair_sums3(x4, y4, z4, partners, p: CellForce3Params, bound: int, with_energy: bool, listed=None):
    """The pair sums of the plain versions on ``(rows, bound, c, c)`` views:
    ``partners(dx)`` gives the partner views of x offset ``dx`` (x seam
    included); the (y, z) offsets roll with their seams. ``listed``: a
    ``(27, rows, bound, bound, c, c)`` mask of the pairs to keep, offsets
    in the loop's order (None: all). Returns full ``(rows, cap, c * c)``
    grids, zero at slots ``>= bound``."""
    c, cap = p.cps, p.cap
    rows = x4.shape[0]
    dt, dev = x4.dtype, x4.device
    idx = torch.arange(c, device=dev)
    xi, yi, zi = x4[:, :, None], y4[:, :, None], z4[:, :, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    fscale = p.fscale
    out = [torch.zeros_like(x4) for _ in range(5 if with_energy else 3)]
    for o, (xp, yp, zp) in enumerate(_partner_views(partners, p.box, idx, dt)):
        ddx = xi - xp
        ddy = yi - yp
        ddz = zi - zp
        r2 = ddx * ddx + ddy * ddy + ddz * ddz
        valid = (r2 > 0.0) & (r2 < p.cutoff2)
        if listed is not None:
            valid = valid & listed[o]
        inv = p.sigma2 / r2
        s6 = inv * inv * inv
        if with_energy:
            s12 = s6 * s6
            fmag = torch.where(valid, (2.0 * s12 - s6) * inv, zero) * fscale
            out[3] += torch.where(valid, 4.0 * p.epsilon * (s12 - s6) - p.shift, zero).sum(2)
            out[4] += (torch.where(valid, 2.0 * s12 - s6, zero) * (fscale * p.sigma2)).sum(2)
        else:
            fmag = torch.where(valid, s6 * inv * (2.0 * fscale * s6 - fscale), zero)
        out[0] += (fmag * ddx).sum(2)
        out[1] += (fmag * ddy).sum(2)
        out[2] += (fmag * ddz).sum(2)
    full = []
    for o in out:
        g = torch.zeros((rows, cap, c, c), dtype=dt, device=dev)
        g[:, :bound] = o
        full.append(g.view(rows, cap, c * c))
    return tuple(full)


def _partner_views(partners, box: float, idx: torch.Tensor, dt):
    """The partner views ``(xp, yp, zp)``, ``(rows, 1, bound, c, c)``, of
    the 27 offsets in the loop's order (dx, then dy, then dz), seams
    added: ``partners(dx)`` gives the x offset's views."""
    c = idx.shape[0]

    def seam(d):
        # +box where index + d wraps past the top, -box past the bottom
        return ((idx + d >= c).to(dt) - (idx + d < 0).to(dt)) * box

    for dx in (-1, 0, 1):
        xr, yr, zr = partners(dx)
        for dy in (-1, 0, 1):
            xr2 = torch.roll(xr, -dy, 2)
            yr2 = torch.roll(yr, -dy, 2) + seam(dy)[None, None, :, None]
            zr2 = torch.roll(zr, -dy, 2)
            for dz in (-1, 0, 1):
                yield (torch.roll(xr2, -dz, 3)[:, None], torch.roll(yr2, -dz, 3)[:, None],
                       (torch.roll(zr2, -dz, 3) + seam(dz)[None, None, None, :])[:, None])


@dataclass(frozen=True)
class PartnerList3:
    """The partner list of one binning (``PartnerList`` in
    ``csrc/cell_force3.cu``), for the counted kernel at bound ``cov`` (0:
    B4, bound ``max_occ``, shared memory for the capacity) in strips of
    ``strip`` z-cells, ``k`` entries a target, ``slots`` (``cov``, or B4's
    capacity) staged slots a cell. ``words`` (int16): each strip's target
    counts (``LIST_FULL``: over ``k``), then its entries, ``staged cell <<
    7 | slot`` in the counted loop's order, four to a group, ``(n_strips,
    k / 4, stride, 4)``; a partial last group is padded with ``slots``
    (cell 0, the far slot)."""

    words: Optional[torch.Tensor]
    cps: int
    cov: int
    slots: int
    strip: int
    k: int

    @property
    def n_strips(self) -> int:
        return self.cps * self.cps * -(-self.cps // self.strip)

    @property
    def stride(self) -> int:
        """Targets a strip has room for: ``strip * slots`` rounded up to 4."""
        return (self.strip * self.slots + 3) // 4 * 4

    @property
    def counts(self) -> torch.Tensor:
        """``(n_strips, stride)`` int32 entry counts, ``LIST_FULL`` where full."""
        n = self.n_strips * self.stride
        return self.words[:n].view(self.n_strips, self.stride).to(torch.int32) & 0xFFFF

    @property
    def entries(self) -> torch.Tensor:
        """``(n_strips, stride, k)`` int32 entries of each target, in order."""
        n = self.n_strips * self.stride
        e = self.words[n:].view(self.n_strips, self.k // 4, self.stride, 4).to(torch.int32) & 0xFFFF
        return e.permute(0, 2, 1, 3).reshape(self.n_strips, self.stride, self.k)


def list_radius2(cutoff: float, skin: float, box: float, steps: int = LIST_STEPS) -> float:
    """The squared radius of a partner list, a float32 value: ``cutoff +
    skin`` widened for float32 rounding, so that no pair the skin test lets
    through is left out. While the window's skin flag holds, each particle's
    float32 displacement since the binning is at most skin/2; its float32
    coordinate may stray from the binned one plus that displacement by half
    an ulp of ``|x| <= box + skin`` a step on each axis (less with Kahan
    compensation), ``u (box + skin)`` a step with ``u = 2^-24``, over at
    most ``steps`` steps (``LIST_STEPS``); the seam offset adds a rounding
    of ``u (2 box + skin)`` on each axis at the binning and at the step, and
    r^2 a few ``u`` of r. Each of two partners on three axes, hence
    ``2 sqrt(3)``; r^2 in float32, rounded up."""
    u = 2.0**-24
    margin = 2.0 * math.sqrt(3.0) * u * (steps * (box + skin) + 2.0 * box + skin) + 4.0 * u * (cutoff + skin)
    r2 = torch.tensor((cutoff + skin + margin) ** 2, dtype=torch.float32)
    return float(torch.nextafter(r2, torch.tensor(math.inf, dtype=torch.float32)))


def list_capacity(n: int, box: float, rlist2: float) -> int:
    """Entries a target (``k``): the mean number of partners within the
    list radius at density ``n / box^3``, ``m``, plus ``6 sqrt(m)``, rounded
    up to a multiple of 8 (B5's ``cov`` rule with a wider margin: a target
    over it runs the counted loop, so the margin buys speed, not
    correctness)."""
    m = n / float(box) ** 3 * 4.0 / 3.0 * math.pi * rlist2**1.5
    return min(max(8, -(-int(math.ceil(m + 6.0 * math.sqrt(m))) // 8) * 8), LIST_FULL - 3)


def list_bound_ok(static_cov: Optional[int], cap: int) -> bool:
    """Whether the partner list holds the counted kernel's slots at bound
    ``static_cov`` (None: B4 at the capacity ``cap``)."""
    return (static_cov or cap) <= LIST_MAX_BOUND


def list_strip(p: CellForce3Params, static_cov: Optional[int], device) -> int:
    """The strip of a partner list: on the card the force-only counted
    kernel's (:func:`strip_width`), on the CPU the widest balanced one of at
    most 16 z-cells."""
    if torch.device(device).type == "cuda":
        return strip_width(p, p.cps, static_cov, False, device)
    k = -(-p.cps // 16)
    return -(-p.cps // k)


def _list_targets(occ: torch.Tensor, strip: int, stride: int):
    """Each occupied target slot's place in a partner list: ``occ`` is the
    ``(c, bound, c, c)`` occupancy of the slots below the bound (filled from
    0). Returns the targets' flat ``(c, bound, c, c)`` indices and their
    ``(strip, local target)`` as one flat index into ``(n_strips, stride)``,
    numbered as the counted kernel numbers them."""
    c = occ.shape[0]
    nzb = -(-c // strip)
    cnt = occ.sum(1)  # (c, c, c) per cell
    padded = torch.zeros((c, c, nzb * strip), dtype=cnt.dtype, device=occ.device)
    padded[..., :c] = cnt
    padded = padded.view(c, c, nzb, strip)
    first = (torch.cumsum(padded, -1) - padded).view(c, c, nzb * strip)[..., :c]  # (cx, cy, cz)
    cz = torch.arange(c, device=occ.device)
    cxy = torch.arange(c * c, device=occ.device).view(c, c, 1)
    sid = cxy * nzb + (cz // strip)[None, None]  # (cx, cy, cz)
    a = torch.arange(occ.shape[1], device=occ.device).view(1, -1, 1, 1)
    place = sid[:, None] * stride + first[:, None] + a  # (c, bound, c, c)
    flat = torch.nonzero(occ.reshape(-1)).squeeze(1)
    return flat, place.reshape(-1)[flat]


def build_partner_list3_reference(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    rlist2: float,
    k: int,
    bound: int,
    cov: int,
    strip: int,
) -> Tuple[PartnerList3, torch.Tensor]:
    """Plain PyTorch version of the list build at bound ``bound`` (``cov``:
    B5's, 0 for B4): ``(list, full)``, ``full`` the 0-d int32 count of
    targets marked full. Each target keeps the candidates of the counted
    loop, in its order, whose float32 ``r2`` is not ``>= rlist2``, itself
    excepted; the words past a target's last group are the pad."""
    c, cap = p.cps, p.cap
    dev = xg.device
    slots = cov or cap
    x4, y4, z4 = (g.view(c, cap, c, c)[:, :bound] for g in (xg, yg, zg))
    occ = x4 != p.sentinel
    keep = []
    xi, yi, zi = x4[:, :, None], y4[:, :, None], z4[:, :, None]
    a = torch.arange(bound, device=dev)
    views = _partner_views(_grid_partners(x4, y4, z4, p), p.box, torch.arange(c, device=dev), x4.dtype)
    for o, (xp, yp, zp) in enumerate(views):
        ddx = xi - xp
        ddy = yi - yp
        ddz = zi - zp
        r2 = ddx * ddx + ddy * ddy + ddz * ddz
        kept = ~(r2 >= rlist2) & occ[:, :, None] & _occ_view(occ, o)
        if o == 13:
            kept &= (a[:, None] != a[None, :])[None, :, :, None, None]
        keep.append(kept)
    kp = torch.stack(keep).permute(1, 2, 4, 5, 0, 3).reshape(c, bound, c, c, 27 * bound)
    n = kp.sum(-1).to(torch.int32)  # (c, bound, c, c)
    pos = torch.cumsum(kp, -1, dtype=torch.int32) - 1
    # each (offset, slot)'s entry at a target in z-cell cz: staged cell
    # r * (strip + 2) + cz % strip + dz
    oo = torch.arange(27, device=dev)
    cell = (oo // 3)[None, :] * (strip + 2) + (torch.arange(c, device=dev) % strip)[:, None] + (oo % 3)[None, :]
    ent = ((cell[:, :, None] << LIST_SLOT_BITS) | a[None, None, :]).to(torch.int32).reshape(1, 1, 1, c, 27 * bound)
    dense = torch.full((c * bound * c * c, k), slots, dtype=torch.int32, device=dev)
    sel = (kp & (pos < k)).reshape(-1, 27 * bound)
    rows = torch.arange(dense.shape[0], device=dev)[:, None].expand_as(sel)
    dense[rows[sel], pos.reshape(-1, 27 * bound)[sel]] = ent.expand(c, bound, c, c, -1).reshape(-1, 27 * bound)[sel]

    plist = PartnerList3(None, c, cov, slots, strip, k)
    n_words = plist.n_strips * plist.stride * (k + 1)
    words = torch.full((n_words,), slots, dtype=torch.int32, device=dev)
    words[: plist.n_strips * plist.stride] = 0
    flat, place = _list_targets(occ, strip, plist.stride)
    n_t = n.reshape(-1)[flat]
    words[place] = torch.where(n_t <= k, n_t, LIST_FULL)
    groups = words[plist.n_strips * plist.stride:].view(plist.n_strips, k // 4, plist.stride, 4)
    s, t = place // plist.stride, place % plist.stride
    groups[s, :, t] = dense[flat].view(-1, k // 4, 4)
    words = torch.where(words > 0x7FFF, words - 0x10000, words).to(torch.int16)
    return dataclass_replace(plist, words=words), (n_t > k).sum().to(torch.int32)


def _occ_view(occ: torch.Tensor, o: int) -> torch.Tensor:
    """The partners' occupancy at offset ``o`` (the loop's order), as
    ``(c, 1, bound, c, c)``."""
    dx, dy, dz = o // 9 - 1, (o // 3) % 3 - 1, o % 3 - 1
    return torch.roll(occ, (-dx, -dy, -dz), (0, 2, 3))[:, None]


def _listed_pairs(plist: PartnerList3, occ: torch.Tensor) -> torch.Tensor:
    """The ``(27, c, bound, bound, c, c)`` mask of the pairs ``plist``
    keeps (all of a full target's) on a grid whose slots below the bound
    are occupied where ``occ`` says."""
    c, bound = occ.shape[0], occ.shape[1]
    dev = occ.device
    flat, place = _list_targets(occ, plist.strip, plist.stride)
    counts = plist.counts.reshape(-1)[place]
    full = counts == LIST_FULL
    ent = plist.entries.reshape(-1, plist.k)[place]  # (targets, k)
    take = torch.arange(plist.k, device=dev)[None] < torch.where(full, 0, counts)[:, None]
    cell, b = ent >> LIST_SLOT_BITS, ent & ((1 << LIST_SLOT_BITS) - 1)
    cz = (flat % c)[:, None]
    dzi = cell % (plist.strip + 2) - cz % plist.strip
    o = (cell // (plist.strip + 2)) * 3 + dzi
    take &= (b < bound) & (dzi >= 0) & (dzi < 3)
    mask = torch.zeros((c * bound * c * c, 27 * bound), dtype=torch.bool, device=dev)
    rows = flat[:, None].expand_as(take)
    mask[rows[take], (o * bound + b)[take]] = True
    mask[flat[full]] = True
    return mask.view(c, bound, c, c, 27, bound).permute(4, 0, 1, 5, 2, 3)


def strip_width(p: CellForce3Params, rows: int, cov: Optional[int], with_energy: bool, device) -> int:
    """The z-cells a block of the counted kernel takes on ``rows`` output
    x-rows at bound ``cov`` (None: B4, shared memory for the capacity) on
    CUDA ``device``: the widest ``ceil(ncz / k)`` whose blocks are all
    resident on the card at once, from the occupancy calculator, else the
    widest balanced one of at most 16 that fits (``pick_strip`` in
    ``csrc/cell_force3.cu``)."""
    return _strip_width(cov or 0, p.cap, bool(with_energy), rows, p.cps, torch.device(device).index or 0)


@functools.lru_cache(maxsize=None)
def _strip_width(cov: int, cap: int, with_energy: bool, rows: int, cps: int, index: int) -> int:
    fn = _build.library().jtps_cell_force3_counted_strip
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    w = ctypes.c_int(0)
    _build.check(fn(cov, cap, int(with_energy), rows, cps, cps, index, ctypes.byref(w)), "cell_force3 strip choice")
    return w.value


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_cell_force3
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 7
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _counted_launcher():
    fn = _build.library().jtps_cell_force3_counted
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 7
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _listed_launcher():
    fn = _build.library().jtps_cell_force3_listed
    fn.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 7
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _build_launcher():
    fn = _build.library().jtps_cell_list3_build
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 5
        + [ctypes.c_float] * 3
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def build_partner_list3(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    rlist2: float,
    k: int,
    max_occ: Optional[torch.Tensor] = None,
    static_cov: Optional[int] = None,
    full: Optional[torch.Tensor] = None,
) -> Tuple[PartnerList3, torch.Tensor]:
    """The partner list of the binning the grids hold, for B5 at
    ``static_cov`` or B4 at bound ``max_occ`` (None: the capacity), in
    strips of :func:`list_strip` z-cells, ``k`` entries a target,
    radius^2 ``rlist2`` (:func:`list_radius2`). Returns
    ``(list, full + the targets marked full)``, a new 0-d int32 (``full``
    None: 0). A CPU tensor takes the plain version, a CUDA tensor one
    launch of ``cell_list3_build_kernel``."""
    global LIST_BUILD_LAUNCHES
    dev = xg.device
    grids = (xg, yg, zg)
    for t, name in zip(grids, ("xg", "yg", "zg")):
        check_grid(t, name, p.grid_shape, dev)
    if static_cov is not None and not 0 < static_cov <= p.cap:
        raise ValueError(f"static_cov {static_cov} must lie in [1, capacity {p.cap}]")
    if not list_bound_ok(static_cov, p.cap):
        raise ValueError(f"a partner list holds slots below {LIST_MAX_BOUND + 1}, not {static_cov or p.cap}")
    if k % 4 or not 0 < k < LIST_FULL:
        raise ValueError(f"k {k}: a partner list holds a positive multiple of 4 below {LIST_FULL} entries")
    strip = list_strip(p, static_cov, dev)
    if full is None:
        full = torch.zeros((), dtype=torch.int32, device=dev)
    if full.dtype != torch.int32 or full.numel() != 1 or full.device != dev:
        raise TypeError(f"full: expected one int32 on {dev}, got {full.dtype} {tuple(full.shape)} on {full.device}")
    if dev.type == "cpu":
        bound = static_cov if static_cov is not None else (p.cap if max_occ is None else int(max_occ))
        plist, n_full = build_partner_list3_reference(
            *grids, p, rlist2, k, min(max(bound, 0), p.cap), static_cov or 0, strip)
        return plist, full + n_full
    if dev.type != "cuda":
        raise ValueError(f"the 3D force kernels run on cpu or cuda tensors, not {dev}")
    if static_cov is not None and static_cov not in STATIC_COVS:
        raise ValueError(f"the B5 kernel is built for static_cov in {STATIC_COVS}, not {static_cov}")
    cov = static_cov or 0
    plist = PartnerList3(None, p.cps, cov, cov or p.cap, strip, k)
    words = torch.empty((plist.n_strips * plist.stride * (k + 1),), dtype=torch.int16, device=dev)
    out = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mo = None if (max_occ is None or static_cov is not None) else max_occ.data_ptr()
    status = _build_launcher()(
        xg.data_ptr(), yg.data_ptr(), zg.data_ptr(), mo, cov, p.cps, p.cap, p.cps, p.cps,
        p.box, p.sentinel, rlist2, strip, k, words.data_ptr(), full.data_ptr(), out.data_ptr(),
        _sync_words(dev, stream).data_ptr(), dev.index, stream,
    )
    _build.check(status, "cell_list3 build kernel")
    LIST_BUILD_LAUNCHES += 1
    return dataclass_replace(plist, words=words), out


def _forces3(grids, p: CellForce3Params, max_occ, with_energy: bool, static_cov, halo: bool,
             loop: bool = False, strip: Optional[int] = None, plist: Optional[PartnerList3] = None):
    """Checks the arguments of :func:`grid_force3` (``halo=False``) or
    :func:`grid_force3_halo` (``halo=True``: each grid carries one halo
    x-row on each side) and runs the plain version on the CPU or a kernel
    on the card: the counted kernel, B4 or with ``static_cov`` B5, in
    strips of ``strip`` z-cells (default: :func:`strip_width`; another
    width is for measuring the choice), with ``plist`` its list form, or
    with ``loop`` the full loop. Returns the outputs and whether a kernel
    launched."""
    dev = grids[0].device
    rows = grids[0].shape[0] - 2 if halo else p.cps
    if rows < 1:
        raise ValueError(f"xg: expected at least one local x-row, got shape {tuple(grids[0].shape)}")
    shape = (rows + 2 if halo else rows, p.cap, p.cps * p.cps)
    for t, name in zip(grids, ("xg", "yg", "zg")):
        check_grid(t, name, shape, dev)
    if static_cov is not None and not 0 < static_cov <= p.cap:
        raise ValueError(f"static_cov {static_cov} must lie in [1, capacity {p.cap}]")
    if static_cov is None and not loop and p.cap > MAX_CAP:
        raise ValueError(f"capacity {p.cap}: B4's shared memory holds capacities up to MAX_CAP = {MAX_CAP}")
    if max_occ is not None and static_cov is None:
        if max_occ.dtype != torch.int32 or max_occ.numel() != 1:
            raise TypeError(f"max_occ: expected one int32, got {max_occ.dtype} {tuple(max_occ.shape)}")
        if max_occ.device != dev:
            raise ValueError(f"max_occ: on {max_occ.device}, expected {dev}")
    if strip is not None and (loop or not 1 <= strip <= min(MAX_STRIP, p.cps)):
        raise ValueError(f"strip {strip}: the counted kernel takes 1 to {min(MAX_STRIP, p.cps)} z-cells")
    if plist is not None:
        if halo or loop or with_energy or strip is not None:
            raise ValueError("the list form is the force-only counted kernel on the whole grid")
        if (plist.cov, plist.slots, plist.cps) != (static_cov or 0, static_cov or p.cap, p.cps):
            raise ValueError(f"plist: built for bound {plist.cov or 'max_occ'} on {plist.cps} cells a side, "
                             f"not bound {static_cov or 'max_occ'} on {p.cps}")
        if plist.words.device != dev:
            raise ValueError(f"plist: on {plist.words.device}, expected {dev}")
    if dev.type == "cpu":
        bound = static_cov if static_cov is not None else max_occ
        bound = None if bound is None else int(bound)
        if plist is not None:
            return grid_force3_list_reference(*grids, p, plist, bound), False
        ref = grid_force3_halo_reference if halo else grid_force3_reference
        return ref(*grids, p, bound, with_energy), False
    if dev.type != "cuda":
        raise ValueError(f"the 3D force kernels run on cpu or cuda tensors, not {dev}")
    if static_cov is not None and static_cov not in STATIC_COVS:
        raise ValueError(f"the B5 kernel is built for static_cov in {STATIC_COVS}, not {static_cov}")
    outs = [torch.empty((rows, p.cap, p.cps * p.cps), dtype=grids[0].dtype, device=dev)
            for _ in range(5 if with_energy else 3)]
    ptrs = [g.data_ptr() for g in grids] + [o.data_ptr() for o in outs[:3]]
    ptrs += [o.data_ptr() for o in outs[3:]] if with_energy else [None, None]
    ptrs.append(None if (max_occ is None or static_cov is not None) else max_occ.data_ptr())
    consts = (p.box, p.sentinel, p.cutoff2, p.sigma2, p.fscale, p.epsilon, p.shift)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape_args = (static_cov or 0, rows, p.cap, p.cps, p.cps, *consts, int(with_energy), int(halo))
    if loop:
        status = _launcher()(*ptrs, *shape_args, dev.index, stream)
    elif plist is not None:
        status = _listed_launcher()(*ptrs[:6], ptrs[8], *shape_args[:-2], plist.strip, plist.words.data_ptr(),
                                    plist.k, dev.index, stream)
    else:
        w = strip_width(p, rows, static_cov, with_energy, dev) if strip is None else strip
        status = _counted_launcher()(*ptrs, *shape_args, w, dev.index, stream)
    _build.check(status, "cell_force3 halo kernel" if halo else "cell_force3 kernel")
    return tuple(outs), True


def grid_force3(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    max_occ: Optional[torch.Tensor] = None,
    with_energy: bool = False,
    static_cov: Optional[int] = None,
    plist: Optional[PartnerList3] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(fx, fy, fz)`` (or ``(fx, fy, fz, e, w)``) totals on the cell grid.

    B4 (``static_cov=None``) covers slots below ``max_occ``, a 0-d int32
    tensor on the grids' device (None: the full capacity, at most
    ``MAX_CAP``); B5 covers slots below ``static_cov`` and ignores
    ``max_occ``. On the card both are the counted kernel: the grids' cells
    must fill their slots from 0. ``plist`` (force-only): the list form,
    on the partner list that :func:`build_partner_list3` built on this
    binning at the same bound."""
    global LAUNCHES, ENERGY_LAUNCHES, COUNTED_LAUNCHES, LIST_LAUNCHES
    outs, launched = _forces3((xg, yg, zg), p, max_occ, with_energy, static_cov, halo=False, plist=plist)
    if launched:
        if plist is not None:
            LIST_LAUNCHES += 1
        if static_cov is not None:
            COUNTED_LAUNCHES += 1
        elif with_energy:
            ENERGY_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return outs


def grid_force3_halo(
    xh: torch.Tensor,
    yh: torch.Tensor,
    zh: torch.Tensor,
    p: CellForce3Params,
    max_occ: Optional[torch.Tensor] = None,
    with_energy: bool = False,
    static_cov: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """B4/B5 halo: :func:`grid_force3` on the local x-rows of
    ``(rows + 2, cap, ncy * ncz)`` grids that carry one halo x-row on each
    side; ``max_occ`` is the bound over all ranks."""
    global HALO_LAUNCHES, HALO_ENERGY_LAUNCHES, HALO_COUNTED_LAUNCHES
    outs, launched = _forces3((xh, yh, zh), p, max_occ, with_energy, static_cov, halo=True)
    if launched:
        if static_cov is not None:
            HALO_COUNTED_LAUNCHES += 1
        elif with_energy:
            HALO_ENERGY_LAUNCHES += 1
        else:
            HALO_LAUNCHES += 1
    return outs


def grid_force3_loop(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    max_occ: Optional[torch.Tensor] = None,
    with_energy: bool = False,
    halo: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """B4 (``halo``: B4 halo) as its full loop: every slot's thread over 27
    cells x ``max_occ`` partner slots (None: the capacity). No path runs
    it; it is the counted kernel's yardstick, bit-equal to it on grids
    whose cells fill their slots from 0. A CPU tensor takes the plain
    version."""
    global LOOP_LAUNCHES, HALO_LOOP_LAUNCHES
    outs, launched = _forces3((xg, yg, zg), p, max_occ, with_energy, None, halo=halo, loop=True)
    if launched:
        if halo:
            HALO_LOOP_LAUNCHES += 1
        else:
            LOOP_LAUNCHES += 1
    return outs


def grid_force3_static_loop(
    xg: torch.Tensor,
    yg: torch.Tensor,
    zg: torch.Tensor,
    p: CellForce3Params,
    static_cov: int,
    with_energy: bool = False,
    halo: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """B5 (``halo``: B5 halo) as its full loop: every slot's thread over 27
    cells x ``static_cov`` partner slots. No path runs it; it is the counted
    kernel's yardstick, bit-equal to it on grids whose cells fill their
    slots from 0. A CPU tensor takes the plain version."""
    global STATIC_LAUNCHES, HALO_STATIC_LAUNCHES
    outs, launched = _forces3((xg, yg, zg), p, None, with_energy, static_cov, halo=halo, loop=True)
    if launched:
        if halo:
            HALO_STATIC_LAUNCHES += 1
        else:
            STATIC_LAUNCHES += 1
    return outs


def make_grid_force_kernel3(
    grid_fn: CellGridFn,
    sigma: float = 1.0,
    epsilon: float = 1.0,
    with_energy: bool = False,
    static_cov: Optional[int] = None,
):
    """``(xg, yg, zg, max_occ=None) -> (fx, fy, fz)`` (or ``(..., e, w)``),
    the counterpart of the JAX package's
    ``cell_pallas3.make_grid_force_kernel3``: B4, or B5 with ``static_cov``
    (which then ignores ``max_occ``)."""
    p = CellForce3Params.from_grid(grid_fn, sigma, epsilon)

    def kernel(xg, yg, zg, max_occ=None):
        return grid_force3(xg, yg, zg, p, max_occ, with_energy, static_cov)

    return kernel
