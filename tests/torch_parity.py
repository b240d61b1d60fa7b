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


def lattice_positions(n: int, box: float, jitter: float = 0.05, seed: int = 0) -> np.ndarray:
    """(n, 2) float32 square-lattice positions with Gaussian jitter, NOT
    wrapped: jitter near the edges leaves some coordinates slightly outside
    [0, box), as unwrapped grid coordinates are between rebuilds."""
    per_side = int(np.ceil(np.sqrt(n)))
    spacing = box / per_side
    g = np.arange(per_side) * spacing + 0.5 * spacing
    r = np.stack(np.meshgrid(g, g, indexing="ij"), axis=-1).reshape(-1, 2)[:n]
    r = r + jitter * np.random.default_rng(seed).standard_normal(r.shape)
    return r.astype(np.float32)


def velocities(n: int, kt: float = 1.0, seed: int = 1) -> np.ndarray:
    v = np.sqrt(kt) * np.random.default_rng(seed).standard_normal((n, 2))
    return v.astype(np.float32)


def jax_grid_arrays(gs) -> dict:
    """The leaves of a JAX GridMDState as numpy arrays by field name."""
    out = {}
    for name in GRID_STATE_FIELDS:
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
