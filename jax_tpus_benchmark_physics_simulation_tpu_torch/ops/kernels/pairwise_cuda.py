"""Kernels B8 (all-pairs Lennard-Jones forces and per-particle energies) and
B9 (all-pairs softened gravitational accelerations and potentials), as the
JAX package's ``ops/kernels/pairwise_pallas.py`` holds both.

B8 replaces the TPU kernel ``ops/kernels/pairwise_pallas.py:_lj_kernel`` of the
JAX package (built by ``make_lj_force_pallas`` and ``make_lj_energy_pallas``).
The CUDA source is ``csrc/pairwise_lj.cu``; its header says what bounds it
on an H100 (the instructions issued a pair, above all on the quarter-rate
unit that runs reciprocals and rounding) and how the design answers that
(one approximate reciprocal a pair, rounding by adding 1.5 * 2^23, explicit
FMAs, four i-particles a thread over shared-memory j-tiles, j split into
slices, a second launch that sums the slices in a fixed order).

Positions are ``(N, D)`` float32 with D = 2 or 3, as the JAX function takes
them: the TPU's 8-wide coordinate padding and its rounding of N up to a
block are gone.

- :func:`lj_force_pairwise_reference`: the plain PyTorch version, the same
  formula in the same form (``dx * (1/box)``), in row chunks of at most
  about 2^27 pairs; used for CPU tensors and as the kernel's reference on
  the card;
- :func:`lj_force_pairwise`: the wrapper. A CPU tensor takes the plain
  version, a CUDA tensor launches the kernel or raises;
- :func:`make_lj_force_pairwise`, :func:`make_lj_energy_pairwise`: the
  counterparts of the JAX package's ``make_lj_force_pallas`` and
  ``make_lj_energy_pallas`` (an energy whose gradient is -force);
- ``LAUNCHES`` / ``ENERGY_LAUNCHES``: kernel launches of the force-only and
  the energy variant, counted where the wrapper launches them.

B9 replaces ``_gravity_kernel`` (built by ``make_gravity_accel_pallas``);
its source is ``csrc/pairwise_gravity.cu``, B8's design with ``(x, y[, z],
m)`` j-tiles and ``rsqrtf`` as the TPU kernel's ``lax.rsqrt``:

- :func:`gravity_accel_pairwise_reference`: the plain version, the Pallas
  body's own formula, in row chunks;
- :func:`gravity_accel_pairwise`: the wrapper (CPU tensor: plain version;
  CUDA tensor: the kernel or raise);
- :func:`make_gravity_accel_pairwise`: the counterpart of
  ``make_gravity_accel_pallas`` (``block_size`` and ``interpret`` have no
  meaning on the card and are not taken);
- ``GRAVITY_LAUNCHES`` / ``GRAVITY_POTENTIAL_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

LAUNCHES = 0
ENERGY_LAUNCHES = 0
GRAVITY_LAUNCHES = 0
GRAVITY_POTENTIAL_LAUNCHES = 0

# B8 (csrc/pairwise_lj.cu): blocks of LJ_THREADS threads take LJ_ROWS
# i-particles (four a thread); j is cut into at most LJ_MAX_SLICES slices of
# whole LJ_TILE tiles: 32 row blocks x 32 slices = 1024 blocks at N=16,384
LJ_THREADS = 128
LJ_ROWS = 4 * LJ_THREADS
LJ_TILE = 512
LJ_MAX_SLICES = 32
# B9 (csrc/pairwise_gravity.cu): one i-particle a thread, 256-particle tiles
THREADS = 256  # kThreads in csrc/pairwise_gravity.cu: a block's rows and a j-tile
MAX_SLICES = 16  # j slices: 64 row blocks x 16 = 1024 blocks at N=16,384
_REFERENCE_PAIRS = 1 << 27  # pair elements one chunk of the plain version holds


@dataclass(frozen=True)
class PairwiseParams:
    """LJ constants of the all-pairs kernel; ``box`` and ``cutoff`` None
    mean no minimum image and no cutoff."""

    sigma: float = 1.0
    epsilon: float = 1.0
    box: Optional[float] = None
    cutoff: Optional[float] = None

    @classmethod
    def of(cls, sigma, epsilon, box, cutoff) -> "PairwiseParams":
        """Params with every constant a Python float (None kept)."""
        return cls(sigma=float(sigma), epsilon=float(epsilon),
                   box=None if box is None else float(box),
                   cutoff=None if cutoff is None else float(cutoff))

    @property
    def shift(self) -> float:
        """U(cutoff), subtracted from every pair energy (0 without a cutoff)."""
        if self.cutoff is None:
            return 0.0
        sc6 = (self.sigma / self.cutoff) ** 6
        return 4.0 * self.epsilon * (sc6 * sc6 - sc6)


def lj_force_pairwise_reference(
    position: torch.Tensor, p: PairwiseParams, with_energy: bool = False
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel: ``(f,)``, or ``(f, e)`` with
    ``with_energy`` (``e`` per particle, total = 0.5 * sum). Works in any
    float dtype."""
    n, dim = position.shape
    dev = position.device
    rows = max(1, _REFERENCE_PAIRS // n)
    cols = torch.arange(n, device=dev)
    zero = position.new_zeros(())
    sigma2 = position.new_full((), p.sigma * p.sigma)
    inv_box = None if p.box is None else 1.0 / p.box
    f_parts, e_parts = [], []
    for r0 in range(0, n, rows):
        xi = position[r0 : r0 + rows]
        dxs = []
        for d in range(dim):
            dx = xi[:, None, d] - position[None, :, d]
            if p.box is not None:
                dx = dx - p.box * torch.round(dx * inv_box)
            dxs.append(dx)
        r2 = dxs[0] * dxs[0]
        for dx in dxs[1:]:
            r2 = r2 + dx * dx
        valid = torch.arange(r0, r0 + xi.shape[0], device=dev)[:, None] != cols[None, :]
        if p.cutoff is not None:
            valid = valid & (r2 < p.cutoff * p.cutoff)
        r2s = torch.where(valid, r2, torch.ones_like(r2))
        inv = sigma2 / r2s
        s6 = inv * inv * inv
        s12 = s6 * s6
        fmag = torch.where(valid, 24.0 * p.epsilon * (2.0 * s12 - s6) / r2s, zero)
        f_parts.append(torch.stack([torch.sum(fmag * dx, dim=1) for dx in dxs], dim=1))
        if with_energy:
            pair = torch.where(valid, 4.0 * p.epsilon * (s12 - s6) - p.shift, zero)
            e_parts.append(torch.sum(pair, dim=1))
    f = torch.cat(f_parts)
    return (f, torch.cat(e_parts)) if with_energy else (f,)


def _cut(n: int, tile: int, max_slices: int) -> Tuple[int, int]:
    """``(S, slice_len)``: at most ``max_slices`` j slices of whole
    ``tile``-particle tiles, none of them empty."""
    tiles = -(-n // tile)
    per_slice = -(-tiles // min(max_slices, tiles))
    return -(-tiles // per_slice), per_slice * tile


def _slices(n: int) -> Tuple[int, int]:
    """B9's ``(S, slice_len)``: at most ``MAX_SLICES`` slices of whole
    ``THREADS``-particle tiles."""
    return _cut(n, THREADS, MAX_SLICES)


def _lj_geometry(n: int) -> Tuple[int, int, int]:
    """B8's launch: ``(row_blocks, S, slice_len)``. Row block ``b`` takes
    i-particles ``b * LJ_ROWS + k * LJ_THREADS + t`` (thread ``t``, ``k`` <
    4) below ``n``; slice ``s`` takes j in ``[s * slice_len, (s + 1) *
    slice_len)`` below ``n``, in tiles of ``LJ_TILE``."""
    return (-(-n // LJ_ROWS),) + _cut(n, LJ_TILE, LJ_MAX_SLICES)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_pairwise_lj
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 4
        + [ctypes.c_float] * 7
        + [ctypes.c_int] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def lj_force_pairwise(
    position: torch.Tensor, p: PairwiseParams, with_energy: bool = False
) -> Tuple[torch.Tensor, ...]:
    """``(f,)`` (or ``(f, e)``): all-pairs LJ forces on ``(N, D)`` float32
    positions, and with ``with_energy`` the per-particle energies."""
    global LAUNCHES, ENERGY_LAUNCHES
    if position.dtype != torch.float32:
        raise TypeError(f"position: expected float32, got {position.dtype}")
    if position.dim() != 2 or position.shape[1] not in (2, 3) or position.shape[0] < 1:
        raise ValueError(f"position: expected shape (N, 2) or (N, 3), got {tuple(position.shape)}")
    if not position.is_contiguous():
        raise ValueError("position: expected a contiguous tensor")
    if position.device.type == "cpu":
        return lj_force_pairwise_reference(position, p, with_energy)
    if position.device.type != "cuda":
        raise ValueError(f"lj_force_pairwise runs on cpu or cuda tensors, not {position.device}")
    n, dim = position.shape
    _, slices, slice_len = _lj_geometry(n)
    partial = torch.empty((slices, n, dim + 1), dtype=torch.float32, device=position.device)
    f = torch.empty_like(position)
    e = torch.empty(n, dtype=torch.float32, device=position.device) if with_energy else None
    box = 0.0 if p.box is None else p.box
    cutoff2 = 0.0 if p.cutoff is None else p.cutoff * p.cutoff  # as the plain version squares it
    status = _launcher()(
        position.data_ptr(), partial.data_ptr(), f.data_ptr(),
        e.data_ptr() if with_energy else None,
        n, dim, slices, slice_len,
        box, 0.0 if p.box is None else 1.0 / p.box, cutoff2, p.sigma * p.sigma,
        24.0 * p.epsilon, 4.0 * p.epsilon, p.shift,
        int(p.box is not None), int(p.cutoff is not None), int(with_energy),
        position.device.index, torch.cuda.current_stream(position.device).cuda_stream,
    )
    _build.check(status, "pairwise_lj kernel")
    if with_energy:
        ENERGY_LAUNCHES += 1
        return f, e
    LAUNCHES += 1
    return (f,)


def make_lj_force_pairwise(
    n: int,
    sigma: float = 1.0,
    epsilon: float = 1.0,
    box: Optional[float] = None,
    cutoff: Optional[float] = None,
    with_energy: bool = False,
):
    """``force_fn(R) -> F`` (or ``(F, E_total)`` with ``with_energy``), the
    same physics as ``LennardJones(...).force``; the counterpart of the JAX
    package's ``make_lj_force_pallas``."""
    p = PairwiseParams.of(sigma, epsilon, box, cutoff)

    def force_fn(position: torch.Tensor):
        if position.shape[0] != n:
            raise ValueError(f"kernel built for N={n}, got {position.shape[0]}")
        if with_energy:
            f, e = lj_force_pairwise(position, p, with_energy=True)
            return f, 0.5 * torch.sum(e)
        return lj_force_pairwise(position, p)[0]

    return force_fn


class _PairwiseEnergy(torch.autograd.Function):
    """Total energy from the energy variant; the gradient is -force, saved
    from the same launch (no backward kernel, as the JAX package has none)."""

    @staticmethod
    def forward(ctx, position, p):
        f, e = lj_force_pairwise(position, p, with_energy=True)
        ctx.save_for_backward(f)
        return 0.5 * torch.sum(e)

    @staticmethod
    def backward(ctx, grad):
        (f,) = ctx.saved_tensors
        return -grad * f, None


def make_lj_energy_pairwise(
    n: int,
    sigma: float = 1.0,
    epsilon: float = 1.0,
    box: Optional[float] = None,
    cutoff: Optional[float] = None,
):
    """``energy(R) -> E_total`` whose autograd gradient is ``-force``, the
    counterpart of the JAX package's ``make_lj_energy_pallas``
    (``jax.custom_vjp``)."""
    p = PairwiseParams.of(sigma, epsilon, box, cutoff)

    def energy(position: torch.Tensor) -> torch.Tensor:
        if position.shape[0] != n:
            raise ValueError(f"kernel built for N={n}, got {position.shape[0]}")
        return _PairwiseEnergy.apply(position, p)

    return energy


# ---------------------------------------------------------------------------
# B9: softened gravity
# ---------------------------------------------------------------------------


def gravity_accel_pairwise_reference(
    position: torch.Tensor,
    masses: torch.Tensor,
    g: float = 1.0,
    softening: float = 0.0,
    with_potential: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of B9: ``(a,)``, or ``(a, phi)`` with
    ``with_potential`` (total potential energy = 0.5 * sum(m * phi)). The
    Pallas body's formula (``pairwise_pallas.py:204-225``): ``dx = x_j -
    x_i``, ``r2 = sum dx^2 + soft^2``, ``inv_r = rsqrt(r2)``, ``a += (g m_j)
    inv_r^3 dx``, ``phi += (-g m_j) inv_r``, ``j == i`` excluded. Works in
    any float dtype, in row chunks of at most about 2^27 pairs."""
    n, dim = position.shape
    dev = position.device
    rows = max(1, _REFERENCE_PAIRS // n)
    cols = torch.arange(n, device=dev)
    zero = position.new_zeros(())
    soft2 = float(softening) ** 2
    gm = (g * masses)[None, :]
    neg_gm = (-g * masses)[None, :]
    a_parts, phi_parts = [], []
    for r0 in range(0, n, rows):
        xi = position[r0 : r0 + rows]
        dxs = [position[None, :, d] - xi[:, None, d] for d in range(dim)]
        r2 = dxs[0] * dxs[0]
        for dx in dxs[1:]:
            r2 = r2 + dx * dx
        r2 = r2 + soft2
        valid = torch.arange(r0, r0 + xi.shape[0], device=dev)[:, None] != cols[None, :]
        inv_r = torch.rsqrt(torch.where(valid, r2, torch.ones_like(r2)))
        inv_r3 = inv_r * inv_r * inv_r
        amag = torch.where(valid, gm * inv_r3, zero)
        a_parts.append(torch.stack([torch.sum(amag * dx, dim=1) for dx in dxs], dim=1))
        if with_potential:
            phi_parts.append(torch.sum(torch.where(valid, neg_gm * inv_r, zero), dim=1))
    a = torch.cat(a_parts)
    return (a, torch.cat(phi_parts)) if with_potential else (a,)


@functools.lru_cache(maxsize=None)
def _gravity_launcher():
    fn = _build.library().jtps_pairwise_gravity
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 4
        + [ctypes.c_float] * 2
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def gravity_accel_pairwise(
    position: torch.Tensor,
    masses: torch.Tensor,
    g: float = 1.0,
    softening: float = 0.0,
    with_potential: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``(a,)`` (or ``(a, phi)``): all-pairs softened gravitational
    accelerations on ``(N, D)`` float32 positions with ``(N,)`` float32
    masses, and with ``with_potential`` the per-particle potentials."""
    global GRAVITY_LAUNCHES, GRAVITY_POTENTIAL_LAUNCHES
    for name, t in (("position", position), ("masses", masses)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if position.dim() != 2 or position.shape[1] not in (2, 3) or position.shape[0] < 1:
        raise ValueError(f"position: expected shape (N, 2) or (N, 3), got {tuple(position.shape)}")
    if tuple(masses.shape) != (position.shape[0],):
        raise ValueError(f"masses: expected shape ({position.shape[0]},), got {tuple(masses.shape)}")
    if masses.device != position.device:
        raise ValueError(f"masses on {masses.device}, position on {position.device}")
    if position.device.type == "cpu":
        return gravity_accel_pairwise_reference(position, masses, g, softening, with_potential)
    if position.device.type != "cuda":
        raise ValueError(f"gravity_accel_pairwise runs on cpu or cuda tensors, not {position.device}")
    n, dim = position.shape
    slices, slice_len = _slices(n)
    partial = torch.empty((slices, n, dim + 1), dtype=torch.float32, device=position.device)
    a = torch.empty_like(position)
    phi = torch.empty(n, dtype=torch.float32, device=position.device) if with_potential else None
    status = _gravity_launcher()(
        position.data_ptr(), masses.data_ptr(), partial.data_ptr(), a.data_ptr(),
        phi.data_ptr() if with_potential else None,
        n, dim, slices, slice_len, float(g), float(softening) ** 2, int(with_potential),
        position.device.index, torch.cuda.current_stream(position.device).cuda_stream,
    )
    _build.check(status, "pairwise_gravity kernel")
    if with_potential:
        GRAVITY_POTENTIAL_LAUNCHES += 1
        return a, phi
    GRAVITY_LAUNCHES += 1
    return (a,)


def make_gravity_accel_pairwise(
    n: int, g: float = 1.0, softening: float = 0.0, with_potential: bool = False
):
    """``accel_fn(R, masses) -> A`` (Plummer-softened), or ``(A, phi)`` with
    ``with_potential``; the counterpart of the JAX package's
    ``make_gravity_accel_pallas``, the same physics as
    ``Gravity(mode="plummer", softening=softening).acceleration``."""

    def accel_fn(position: torch.Tensor, masses: torch.Tensor):
        if position.shape[0] != n:
            raise ValueError(f"kernel built for N={n}, got {position.shape[0]}")
        out = gravity_accel_pairwise(position, masses, g, softening, with_potential)
        return out if with_potential else out[0]

    return accel_fn
