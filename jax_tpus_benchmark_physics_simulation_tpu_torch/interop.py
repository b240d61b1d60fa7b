"""Carries state exported from the JAX package into the port.

The JAX package's arrays cross as numpy arrays (``np.asarray`` on the JAX
side), so this module never imports jax. With these, one state can be run
through both packages and compared.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import CellAssignment
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD, GridMDState
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3, GridMD3State
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.neighbor_list import NeighborList

_GRID_FIELDS = (
    "xg", "yg", "vxg", "vyg", "fxg", "fyg", "occ", "dispx", "dispy",
    "crx", "cry", "cvx", "cvy",
)
_GRID3_FIELDS = (
    "xg", "yg", "zg", "vxg", "vyg", "vzg", "fxg", "fyg", "fzg", "occ",
    "dispx", "dispy", "dispz", "crx", "cry", "crz", "cvx", "cvy", "cvz",
)


def _grids(arrays: Mapping[str, np.ndarray], names, shape, live: int, device) -> dict:
    """The named float grids (and pid as int32) of a JAX grid state, with
    the TPU's padding lanes (last axis ``>= live``) dropped; absent or None
    leaves are skipped."""

    def grid(name, dtype):
        a = np.asarray(arrays[name])
        if a.shape[:2] != shape or a.shape[2] < live:
            raise ValueError(f"{name}: shape {a.shape} is not a {shape + (f'>={live}',)} grid")
        return torch.from_numpy(np.ascontiguousarray(a[:, :, :live], dtype=dtype)).to(device)

    out = {name: grid(name, np.float32) for name in names if arrays.get(name) is not None}
    out["pid"] = grid("pid", np.int32)
    return out


def _scalar(arrays: Mapping[str, np.ndarray], name: str, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(arrays[name]).item(), dtype=dtype, device=device)


def grid_state_from_jax(arrays: Mapping[str, np.ndarray], md: GridMD) -> GridMDState:
    """A :class:`GridMDState` from the leaves of a JAX ``GridMDState`` given
    as numpy arrays by field name, on the layout of ``md`` (the JAX engine
    must use the same ``rows_per_block`` R). The TPU's padding lanes
    (``>= R * cps``) are dropped, ``pid`` is cast to int32 and the count grid
    is made from ``occ``. The PRNG key of a Langevin state is not carried
    over: the port's state comes without a noise stream (``rng_seed``
    None), and a Langevin window needs one."""
    dev = md.device
    grids = _grids(arrays, _GRID_FIELDS, md.grid_shape[:2], md.lanes, dev)
    return GridMDState(
        dmax2=_scalar(arrays, "dmax2", torch.float32, dev),
        overflow=_scalar(arrays, "overflow", torch.bool, dev),
        time=_scalar(arrays, "time", torch.float32, dev),
        counts=md._counts(grids["occ"]),
        **grids,
    )


def grid3_state_from_jax(arrays: Mapping[str, np.ndarray], md: GridMD3) -> GridMD3State:
    """A :class:`GridMD3State` from the leaves of a JAX ``GridMD3State``
    given as numpy arrays by field name. The TPU's padding lanes
    (``>= cps * cps``) are dropped, ``pid`` is cast to int32 and ``max_occ``
    is carried as a 0-d int32 tensor. As in 2D, the PRNG key is not carried
    over; ``mover_flags``, which the JAX state lacks, starts at 0."""
    dev = md.device
    return GridMD3State(
        dmax2=_scalar(arrays, "dmax2", torch.float32, dev),
        overflow=_scalar(arrays, "overflow", torch.bool, dev),
        time=_scalar(arrays, "time", torch.float32, dev),
        max_occ=_scalar(arrays, "max_occ", torch.int32, dev),
        mover_flags=torch.zeros((), dtype=torch.int32, device=dev),
        **_grids(arrays, _GRID3_FIELDS, md.grid_shape[:2], md.plane, dev),
    )


def sharded_state_from_jax(arrays: Mapping[str, np.ndarray], md) -> Union[GridMDState, GridMD3State]:
    """This rank's rows of a JAX grid state over the whole grid (a
    ``GridMDState`` at R = 1 or a ``GridMD3State``, as numpy arrays by
    field name), for the row-sharded engine ``md`` (``ShardedGridMD`` or
    ``ShardedGridMD3``): every 3-D leaf is cut to the rank's rows, then
    carried as :func:`grid_state_from_jax` / :func:`grid3_state_from_jax`
    carry a whole state."""
    r0, rows = md._row0, md.rows_local
    local = {k: (np.asarray(v)[r0 : r0 + rows] if np.ndim(v) == 3 else v) for k, v in arrays.items()}
    if isinstance(md, GridMD3):
        return grid3_state_from_jax(local, md)
    return grid_state_from_jax(local, md)


def neighbor_list_from_jax(arrays: Mapping[str, np.ndarray], device="cuda") -> NeighborList:
    """A :class:`NeighborList` from the leaves of a JAX ``NeighborList``
    (``idx``, ``ref_position``, ``overflow``) given as numpy arrays; ``idx``
    becomes int64, PyTorch's index type."""
    return NeighborList(
        idx=torch.from_numpy(np.array(arrays["idx"], dtype=np.int64)).to(device),
        ref_position=torch.from_numpy(np.array(arrays["ref_position"], dtype=np.float32)).to(device),
        overflow=_scalar(arrays, "overflow", torch.bool, device),
    )


def cell_assignment_from_jax(arrays: Mapping[str, np.ndarray], device="cuda") -> CellAssignment:
    """A :class:`CellAssignment` from the leaves of a JAX ``CellAssignment``
    (``slot``, ``occupancy``, ``ref_position``, ``overflow``) given as numpy
    arrays; ``slot`` becomes int64."""
    return CellAssignment(
        slot=torch.from_numpy(np.array(arrays["slot"], dtype=np.int64)).to(device),
        occupancy=torch.from_numpy(np.array(arrays["occupancy"], dtype=bool)).to(device),
        ref_position=torch.from_numpy(np.array(arrays["ref_position"], dtype=np.float32)).to(device),
        overflow=_scalar(arrays, "overflow", torch.bool, device),
    )


def particle_state_from_numpy(position: np.ndarray, velocity: np.ndarray, device="cuda", mass=None,
                              charge=None) -> ParticleState:
    """A float32 :class:`ParticleState` on ``device`` from (N, D) numpy
    positions and velocities, with (N,) ``mass`` and ``charge`` where given
    (unit masses and zero charges where not)."""

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return ParticleState.create(t(position), t(velocity), mass=t(mass), charge=t(charge))


def _tree(value, device, dtype):
    """A numpy array (or scalar) as a tensor, or a dict of them as a dict of
    tensors."""
    if isinstance(value, Mapping):
        return {k: _tree(v, device, dtype) for k, v in value.items()}
    return torch.from_numpy(np.array(value, dtype=dtype)).to(device)


def mc_params_from_jax(params, device="cuda"):
    """VMC parameters exported from the JAX package as numpy: a scalar
    ``alpha`` (the harmonic model) or the ``{alpha, beta}`` dict (the
    anharmonic one), as float32 tensors on ``device``."""
    return _tree(params, device, np.float32)


def adam_state_from_jax(count, mu, nu, device="cuda"):
    """The port's :class:`~jax_tpus_benchmark_physics_simulation_tpu_torch.mc.adam.AdamState`
    from the leaves of optax's ``ScaleByAdamState`` given as numpy arrays:
    ``count`` (int32) and the moments ``mu`` and ``nu`` (a scalar or a dict
    like the params)."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.mc.adam import AdamState

    return AdamState(count=_tree(count, device, np.int32), mu=_tree(mu, device, np.float32),
                     nu=_tree(nu, device, np.float32))
