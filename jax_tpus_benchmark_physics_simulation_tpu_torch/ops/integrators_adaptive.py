"""Adaptive Dormand-Prince RK45 (dopri5) with PI step control.

Port of the JAX package's ``ops/integrators_adaptive.py``: the same
tableau, FSAL reuse of the accepted step's 7th stage, step-size factor,
``max_steps_per_interval`` bound and loud ``steps_exceeded`` flag. JAX's
``lax.scan`` over the output grid with an inner ``lax.while_loop`` becomes a
host loop. The clock ``t``, the step ``dt`` and the comparison ``t < t_next
- 1e-12`` stay 0-d tensors of ``y0``'s dtype (float32), as in JAX, so both
accept the same steps; the accept/reject update is a ``torch.where`` on the
device. What the host must know is whether an interval needs another
attempt: one read of that flag per attempt, a device sync each.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

# Dormand-Prince 5(4) tableau; _C, _B5 and _B4 are float32 constants in
# JAX, so they are rounded to float32 before use in any dtype
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _table(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device).to(like.dtype)


def _dopri5_step(f: Callable, t, y, dt, k1, c, b5, b4):
    """One embedded step from a precomputed ``k1 = f(t, y)`` (FSAL: the 7th
    stage is evaluated at ``(t + dt, y5)``, so an accepted step's ``k7`` is
    the next step's ``k1``). Returns ``(y5, error_estimate, k7)``."""
    ks = [k1]
    for i in range(1, 7):
        ti = t + c[i] * dt
        yi = y
        for j, a in enumerate(_A[i]):
            yi = yi + dt * a * ks[j]
        ks.append(f(ti, yi))
    ks = torch.stack(ks)
    y5 = y + dt * torch.tensordot(b5, ks, dims=1)
    y4 = y + dt * torch.tensordot(b4, ks, dims=1)
    return y5, y5 - y4, ks[6]


class Dopri5Result(NamedTuple):
    ys: torch.Tensor  # (len(ts), state_dim)
    steps_taken: int  # total attempted steps, as the JAX package counts them
    steps_exceeded: bool  # max_steps_per_interval hit in some interval
    ode_evals: int = 0  # total f() evaluations


def dopri5_integrate(
    ode_fn: Callable,  # (t, y) -> dy/dt, y flat (state_dim,)
    y0: torch.Tensor,
    ts,  # (T,) strictly increasing output times, ts[0] = t0
    rtol: float = 1e-6,
    atol: float = 1e-9,
    dt0: Optional[float] = None,
    max_steps_per_interval: int = 10_000,
    safety: float = 0.9,
    min_factor: float = 0.2,
    max_factor: float = 5.0,
) -> Dopri5Result:
    """Integrate to every time in ``ts``; ``ys`` is preallocated and filled
    in place, one row per output time."""
    y0 = torch.as_tensor(y0)
    ts = torch.as_tensor(ts, dtype=y0.dtype, device=y0.device)
    ts_host = ts.cpu()
    if dt0 is None:
        dt0 = (ts[1] - ts[0]) / 10.0 if ts.shape[0] > 1 else 1e-3
    dt = torch.as_tensor(dt0, dtype=y0.dtype, device=y0.device).clone()
    c, b5, b4 = _table(_C, y0), _table(_B5, y0), _table(_B4, y0)

    def err_norm(err, y_old, y_new):
        scale = atol + rtol * torch.maximum(torch.abs(y_old), torch.abs(y_new))
        return torch.sqrt(torch.mean((err / scale) ** 2))

    ys = torch.empty((ts.shape[0],) + tuple(y0.shape), dtype=y0.dtype, device=y0.device)
    ys[0] = y0
    t, y = ts[0], y0
    k1 = ode_fn(t, y)  # the single non-FSAL evaluation
    total, evals, exceeded = 0, 1, False
    for idx in range(1, ts.shape[0]):
        t_next = ts[idx]
        # t enters each interval as ts[idx - 1] exactly (JAX carries t_next
        # out of the loop), so the first test needs no device read
        more = bool(ts_host[idx - 1] < ts_host[idx] - 1e-12)
        n = 0
        while more and n < max_steps_per_interval:
            dt_try = torch.minimum(dt, t_next - t)
            y_new, err, k7 = _dopri5_step(ode_fn, t, y, dt_try, k1, c, b5, b4)
            norm = err_norm(err, y, y_new)
            accept = norm <= 1.0
            factor = torch.clamp(
                safety * torch.where(norm > 0, norm, 1e-10) ** -0.2, min_factor, max_factor
            )
            t = torch.where(accept, t + dt_try, t)
            y = torch.where(accept, y_new, y)
            k1 = torch.where(accept, k7, k1)
            dt = dt_try * factor
            n += 1
            evals += 6
            more = bool(t < t_next - 1e-12)  # the one host read of the attempt
        exceeded = exceeded or (n >= max_steps_per_interval and more)
        total += n
        t = t_next
        ys[idx] = y
    return Dopri5Result(ys=ys, steps_taken=total, steps_exceeded=exceeded, ode_evals=evals)
