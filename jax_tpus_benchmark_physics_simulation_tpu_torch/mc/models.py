"""Quantum models for variational / diffusion Monte Carlo.

Port of the JAX package's ``mc/models.py``. Reference model: the
D-dimensional harmonic oscillator with a Gaussian trial wavefunction
(vmc_dmc...:30-47): V = 0.5 |x|^2, log psi = -alpha |x|^2, closed-form
local kinetic energy; exact ground state E_0 = D/2 at alpha = 0.5.

``generic_local_energy`` derives E_L for any log psi by forward-over-reverse
autodiff through ``torch.func`` (the Laplacian of log psi plus |grad log
psi|^2), so a new trial wavefunction needs only a ``log_psi``. Parameters
are a 0-d tensor (alpha) or a dict of 0-d tensors.

Powers are written as products in JAX's order (``lax.integer_pow``:
x^2 = x*x, x^3 = x*(x*x), x^4 = (x*x)*(x*x)); ``torch.pow`` with an
integer exponent above 3 would round differently.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


def _sq(x: torch.Tensor) -> torch.Tensor:
    return x * x


def _quartic(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    return x2 * x2


@dataclass(frozen=True)
class HarmonicOscillator:
    """V(x) = 0.5 |x|^2 with trial psi_alpha(x) = exp(-alpha |x|^2)."""

    dim: int = 3

    def potential(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(_sq(x), dim=-1)

    def log_psi(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return -params * torch.sum(_sq(x), dim=-1)

    def local_energy(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Closed form (vmc_dmc...:36-47):
        KE = -0.5 (lap log psi + |grad log psi|^2) = -0.5 (-2 a D + 4 a^2 r^2)."""
        r2 = torch.sum(_sq(x), dim=-1)
        ke = -0.5 * (-2.0 * params * self.dim + 4.0 * _sq(params) * r2)
        return ke + self.potential(x)

    def drift_force(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Quantum drift grad log psi = -2 alpha x (vmc_dmc...:230-233)."""
        return -2.0 * params * x

    def exact_energy(self) -> float:
        return 0.5 * self.dim

    def exact_params(self) -> float:
        return 0.5


def generic_local_energy(
    log_psi: Callable[[object, torch.Tensor], torch.Tensor],
    potential: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[object, torch.Tensor], torch.Tensor]:
    """E_L(x) = -0.5 (lap log psi + |grad log psi|^2) + V(x) for a single
    walker x of shape (dim,), any differentiable ``log_psi(params, x)``;
    ``torch.func.vmap`` it over walkers."""

    def e_l(params, x):
        g_fn = torch.func.grad(log_psi, argnums=1)
        g = g_fn(params, x)
        # Laplacian: trace of the Hessian of log psi, forward over reverse
        lap = torch.trace(torch.func.jacfwd(g_fn, argnums=1)(params, x))
        return -0.5 * (lap + torch.sum(g * g)) + potential(x)

    return e_l


def anharmonic_ground_state_1d(lam: float, n_grid: int = 2001, x_max: float = 8.0) -> float:
    """Numerically exact 1D ground state of H = -0.5 d^2/dx^2 + 0.5 x^2 +
    lam x^4 by finite-difference diagonalization (a copy of the JAX
    package's oracle, numpy only): the physics oracle of the anharmonic
    model, converged to ~2e-6 at the default grid."""
    x = np.linspace(-x_max, x_max, n_grid)
    h = x[1] - x[0]
    v = 0.5 * x**2 + lam * x**4
    main = 1.0 / h**2 + v  # -0.5 * (-2/h^2) = 1/h^2
    off = -0.5 / h**2 * np.ones(n_grid - 1)
    w = np.linalg.eigvalsh(np.diag(main) + np.diag(off, 1) + np.diag(off, -1))
    return float(w[0])


@dataclass(frozen=True)
class AnharmonicOscillator:
    """V(x) = 0.5 |x|^2 + lam sum_i x_i^4 (separable quartic) with the
    two-parameter trial psi = exp(-alpha |x|^2 - beta sum x_i^4); E_L by
    :func:`generic_local_energy` (no closed form is coded). The exact ground
    state is D * (1D diagonalization) by separability."""

    dim: int = 3
    lam: float = 0.2

    def potential(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.sum(_sq(x), dim=-1) + self.lam * torch.sum(_quartic(x), dim=-1)

    def log_psi(self, params, x: torch.Tensor) -> torch.Tensor:
        return -params["alpha"] * torch.sum(_sq(x), dim=-1) - params["beta"] * torch.sum(_quartic(x), dim=-1)

    def init_params(self, alpha_init: float = 0.6, device="cuda"):
        return {
            "alpha": torch.tensor(alpha_init, dtype=torch.float32, device=device),
            "beta": torch.tensor(0.05, dtype=torch.float32, device=device),
        }

    def local_energy(self, params, x: torch.Tensor) -> torch.Tensor:
        """(n_walkers,) E_L by autodiff (:func:`generic_local_energy`)."""
        e_l = generic_local_energy(self.log_psi, self.potential)
        return torch.func.vmap(e_l, in_dims=(None, 0))(params, x)

    def drift_force(self, params, x: torch.Tensor) -> torch.Tensor:
        """grad log psi = -2 alpha x - 4 beta x^3 (DMC quantum drift)."""
        return -2.0 * params["alpha"] * x - 4.0 * params["beta"] * (x * (x * x))

    def exact_energy(self) -> float:
        return self.dim * anharmonic_ground_state_1d(self.lam)

    def exact_params(self) -> Optional[float]:
        return None  # no closed-form optimum (unlike alpha = 0.5)
