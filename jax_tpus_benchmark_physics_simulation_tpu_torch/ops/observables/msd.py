"""Mean-squared displacement and self-diffusion coefficient (port of the
JAX package's ``ops/observables/msd.py``).

The production ``r_history`` holds positions wrapped into [0, box) at a
fixed sampling stride; it is unwrapped by minimum-image chaining, valid
while no particle moves more than box/2 between samples. MSD(k) averages
over particles and time origins (the sliding-origin estimator); D is the
least-squares slope over the second half of the curve, by the Einstein
relation ``MSD = 2 d D t``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def unwrap_trajectory(r_history: torch.Tensor, box: float) -> torch.Tensor:
    """(S, N, d) wrapped snapshots -> unwrapped (continuous) trajectories."""
    d = torch.diff(r_history, dim=0)
    d = d - box * torch.round(d / box)
    return torch.cat([r_history[:1], r_history[:1] + torch.cumsum(d, dim=0)], dim=0)


def mean_squared_displacement(
    r_history: torch.Tensor, box: float, max_particles: int = 4096
) -> torch.Tensor:
    """MSD over sample lag k = 0..S-1, averaged over particles and time
    origins: ``msd[k] = mean_{t,i} |r_i(t+k) - r_i(t)|^2``. Above
    ``max_particles`` a strided particle subset is used, as in the JAX
    package. All lags are one batched expression: the (lag, origin) pairs
    are gathered at once, as the JAX package's roll-and-mask does per lag."""
    n = r_history.shape[1]
    if max_particles and n > max_particles:
        stride = n // max_particles
        r_history = r_history[:, ::stride][:, :max_particles]
    u = unwrap_trajectory(r_history, box)
    s, n, _ = u.shape
    lag = torch.arange(s, device=u.device)
    later = (lag[:, None] + lag[None, :]) % s  # [k, t] -> the sample t + k (rolled, as JAX)
    diff = u[later] - u[None]  # (lag, origin, N, d)
    sq = torch.sum(torch.sum(diff * diff, dim=-1), dim=-1)  # (lag, origin)
    valid = lag[None, :] < (s - lag)[:, None]
    return torch.sum(torch.where(valid, sq, torch.zeros_like(sq)), dim=1) / (
        torch.clamp(s - lag, min=1) * n
    ).to(u.dtype)


def diffusion_coefficient(
    msd: torch.Tensor, dt_sample: float, dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Einstein-relation fit ``MSD = 2 d D t + c`` over the second half of
    the MSD curve. Returns ``(D, slope_residual_rms)``; the residual is a
    linearity diagnostic (large: the window is not diffusive yet)."""
    s = msd.shape[0]
    k0 = s // 2
    t = torch.arange(k0, s, dtype=msd.dtype, device=msd.device) * dt_sample
    y = msd[k0:]
    tm, ym = torch.mean(t), torch.mean(y)
    slope = torch.sum((t - tm) * (y - ym)) / torch.clamp(torch.sum((t - tm) ** 2), min=1e-30)
    resid = y - (ym + slope * (t - tm))
    return slope / (2.0 * dim), torch.sqrt(torch.mean(resid**2))
