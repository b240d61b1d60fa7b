"""Shared inputs for the PyTorch port's tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; JAX
arrays cross to the port as numpy. This module imports neither jax nor the
JAX package; the jax it patches is imported inside the function that
patches it.
"""

from __future__ import annotations

import contextlib

import numpy as np

# the fields of a JAX GridMDState that interop.grid_state_from_jax reads
GRID_STATE_FIELDS = (
    "xg", "yg", "vxg", "vyg", "fxg", "fyg", "occ", "pid", "dispx", "dispy",
    "dmax2", "overflow", "time", "crx", "cry", "cvx", "cvy",
)
# the fields of a JAX GridMD3State that interop.grid3_state_from_jax reads
GRID3_STATE_FIELDS = (
    "xg", "yg", "zg", "vxg", "vyg", "vzg", "fxg", "fyg", "fzg", "occ", "pid",
    "dispx", "dispy", "dispz", "dmax2", "overflow", "time", "max_occ",
    "crx", "cry", "crz", "cvx", "cvy", "cvz",
)


def lattice_positions(n: int, box: float, jitter: float = 0.05, seed: int = 0, dim: int = 2) -> np.ndarray:
    """(n, dim) float32 square/cubic-lattice positions with Gaussian jitter,
    NOT wrapped: jitter near the edges leaves some coordinates slightly
    outside [0, box), as unwrapped grid coordinates are between rebuilds."""
    per_side = int(np.ceil(n ** (1.0 / dim) - 1e-9))
    spacing = box / per_side
    g = np.arange(per_side) * spacing + 0.5 * spacing
    r = np.stack(np.meshgrid(*([g] * dim), indexing="ij"), axis=-1).reshape(-1, dim)[:n]
    r = r + jitter * np.random.default_rng(seed).standard_normal(r.shape)
    return r.astype(np.float32)


def velocities(n: int, kt: float = 1.0, seed: int = 1, dim: int = 2) -> np.ndarray:
    v = np.sqrt(kt) * np.random.default_rng(seed).standard_normal((n, dim))
    return v.astype(np.float32)


def jax_grid_arrays(gs, fields=GRID_STATE_FIELDS) -> dict:
    """The leaves of a JAX GridMDState (or, with ``GRID3_STATE_FIELDS``,
    GridMD3State) as numpy arrays by field name."""
    out = {}
    for name in fields:
        leaf = getattr(gs, name)
        if leaf is not None:
            out[name] = np.asarray(leaf)
    return out


def periodic_distance(a: np.ndarray, b: np.ndarray, box: float) -> np.ndarray:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % box
    return np.minimum(d, box - d)


@contextlib.contextmanager
def exact_pallas_reciprocal():
    """Inside this block, interpret-mode Pallas lowers
    ``pl.reciprocal(x, approx=True)`` as the exact ``1/x``.

    Interpret mode emulates the approximate reciprocal in bfloat16 (8 bits;
    jax/_src/pallas/primitives.py), where the TPU's hardware reciprocal plus
    the cell kernel's Newton step reaches float32 roundoff. Emulated, the
    JAX cell kernel's forces are off by ~1e-2, which would hide any error of
    the port below that. The JAX package itself is not touched: only the
    lowering of one primitive in this test process, restored on exit."""
    import jax.numpy as jnp
    from jax._src.interpreters import mlir
    from jax._src.pallas import primitives

    prim = primitives.reciprocal_p
    saved = mlir._lowerings[prim]
    mlir.register_lowering(
        prim, mlir.lower_fun(lambda x, approx=False: jnp.reciprocal(x), multiple_results=False)
    )
    try:
        yield
    finally:
        mlir._lowerings[prim] = saved
