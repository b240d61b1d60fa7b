"""Walker resampling (branching) for DMC.

Port of the JAX package's ``mc/resampling.py`` (reference:
``random.choice(p=weights)`` at vmc_dmc...:255-260). Both resamplers are
inverse-CDF: cumsum of the sanitized weights, ``torch.searchsorted(right=
True)`` (``jnp.searchsorted(side="right")``), a clamp to [0, n - 1], then
``index_select``; both keep the population size fixed.

- ``multinomial``: n iid uniforms (distribution-identical to the reference).
- ``systematic``: one uniform offset, a stratified comb (lower variance).

Each has a pure form that takes its uniforms (``*_from``), for tests that
feed JAX's own draws, and a form that draws from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

# the reference's weight hygiene (vmc_dmc...:250-253): NaN/Inf -> tiny,
# renormalize; a degenerate sum -> uniform
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.debug import sanitize_weights as _sanitize


def _gather(walkers: torch.Tensor, cdf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    idx = torch.searchsorted(cdf, points, right=True)
    idx = torch.clamp(idx, 0, walkers.shape[0] - 1)
    return torch.index_select(walkers, 0, idx)


def resample_multinomial_from(walkers: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """n indices iid from Categorical(weights) by the uniforms ``u`` in
    [0, 1), shape ``(n,)``; gathers the walkers."""
    cdf = torch.cumsum(_sanitize(weights), dim=0)
    return _gather(walkers, cdf, u)


def resample_systematic_from(walkers: torch.Tensor, weights: torch.Tensor, u0: torch.Tensor) -> torch.Tensor:
    """Stratified comb: points (i + u0)/n against the weight CDF; ``u0`` a
    0-d uniform in [0, 1)."""
    n = walkers.shape[0]
    w = _sanitize(weights)
    cdf = torch.cumsum(w, dim=0)
    # a tensor divisor: on the card PyTorch multiplies by a Python scalar's reciprocal
    pts = (torch.arange(n, dtype=w.dtype, device=w.device) + u0) / torch.full((), float(n), dtype=w.dtype,
                                                                              device=w.device)
    return _gather(walkers, cdf, pts)


def resample_multinomial(generator: torch.Generator, walkers: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    u = torch.rand((walkers.shape[0],), dtype=weights.dtype, device=weights.device, generator=generator)
    return resample_multinomial_from(walkers, weights, u)


def resample_systematic(generator: torch.Generator, walkers: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    u0 = torch.rand((), dtype=weights.dtype, device=weights.device, generator=generator)
    return resample_systematic_from(walkers, weights, u0)


RESAMPLERS = {
    "multinomial": resample_multinomial,
    "systematic": resample_systematic,
}

# the pure forms, by the same names
RESAMPLERS_FROM = {
    "multinomial": resample_multinomial_from,
    "systematic": resample_systematic_from,
}
