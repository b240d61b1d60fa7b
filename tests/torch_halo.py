"""Helper of the halo-kernel tests (``tests/test_torch_halo_*.py``): grids
read in particle order. Imports neither jax nor the JAX package."""

from __future__ import annotations

import numpy as np


def by_pid(pid: np.ndarray, n: int, *grids: np.ndarray) -> np.ndarray:
    """(n, len(grids)) values of the grids at each particle's slot, in
    particle order (``pid`` < 0 marks an empty slot)."""
    pid = np.asarray(pid).reshape(-1)
    keep = pid >= 0
    out = np.zeros((n, len(grids)), np.float32)
    for k, g in enumerate(grids):
        out[pid[keep].astype(np.int64), k] = np.asarray(g).reshape(-1)[keep]
    return out
