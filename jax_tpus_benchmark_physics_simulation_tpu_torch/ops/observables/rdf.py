"""Radial distribution function g(r) (port of the JAX package's ``rdf.py``).

For large systems the (N, N) distance matrix cannot exist, so g(r) is
estimated from a fixed random subset of ``max_particles`` particles: an
unbiased estimator of the same g(r) with a little more variance. The subset
comes from a ``torch.Generator`` seeded with ``seed``; it cannot match the
JAX package's ``jax.random.permutation`` draw for draw, so the two agree
exactly only when no subset is taken (N <= ``max_particles``).

The histogram is the JAX package's: below the comparison budget it counts
``#(edge[b]^2 <= r2 < edge[b+1]^2)`` per bin (here by a search over the
sorted squared edges, which gives the same integers without the
(nbins, pairs) comparison block); above it, the arithmetic bin index
``floor(r / bin_w)``.
"""

from __future__ import annotations

import math

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.pbc import pair_displacements

_COMPARE_BUDGET = 2 * 10**9
_DEFAULT_MAX_PARTICLES = 4096


def radial_distribution(
    r_history: torch.Tensor,  # (S, N, dim)
    box: float,
    nbins: int,
    r_max: float,
    dim: int = 2,
    max_particles: int = _DEFAULT_MAX_PARTICLES,
    seed: int = 0,
):
    """Returns ``(bin_centers, g_r)``, each shape (nbins,)."""
    s, n, _ = r_history.shape
    dev = r_history.device
    if n > max_particles:
        # fixed, seed-stable random subset (not a stride: particle order can
        # be spatially correlated, e.g. lattice inits)
        gen = torch.Generator().manual_seed(seed)
        perm = torch.randperm(n, generator=gen)[:max_particles].to(dev)
        r_history = r_history[:, perm, :]
        n = max_particles

    r_bins = torch.linspace(0.0, r_max, nbins + 1, dtype=torch.float32, device=dev)
    bin_centers = 0.5 * (r_bins[:-1] + r_bins[1:])
    if dim == 2:
        shell = math.pi * (r_bins[1:] ** 2 - r_bins[:-1] ** 2)
    elif dim == 3:
        shell = (4.0 / 3.0) * math.pi * (r_bins[1:] ** 3 - r_bins[:-1] ** 3)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    rho_pairs = (n * (n - 1) / 2.0) / (box**dim)
    ideal_counts = rho_pairs * shell

    iu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev), diagonal=1)
    use_compare = (nbins + 1) * n * n <= _COMPARE_BUDGET
    edges2 = r_bins * r_bins
    bin_w = r_max / nbins

    total = torch.zeros(nbins, dtype=torch.float32, device=dev)
    for i in range(s):
        dr = pair_displacements(r_history[i], box)
        r2 = torch.sum(dr * dr, dim=-1)
        if use_compare:
            idx = torch.searchsorted(edges2, r2[iu], right=True) - 1
            idx = torch.where((idx >= 0) & (idx < nbins), idx, nbins)
        else:
            r = torch.sqrt(r2)
            idx = torch.clamp((r / bin_w).to(torch.int64), max=nbins)
            idx = torch.where(iu & (r < r_max), idx, nbins).reshape(-1)
        total += torch.bincount(idx, minlength=nbins + 1)[:nbins].to(torch.float32)
    g_r = (total / s) / ideal_counts
    return bin_centers, g_r
