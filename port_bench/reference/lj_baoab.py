"""Plain reference of the grid engines' BAOAB Langevin windows (NVT): float64,
in eager PyTorch, over ``lj_nve.py``'s Verlet pair list and truncated,
shifted Lennard-Jones.

It imports nothing of the program and takes nothing the program made but
the start state it is handed, the stream seed and the start state's global
step. The physics is the program's by definition of the model: unit
masses, ``c1 = exp(-gamma dt)``, ``c2 = sqrt(kT (1 - c1^2))``, and each step

    B  v <- v + dt/2 f
    A  r <- r + dt/2 v
    O  v <- c1 v + c2 xi(t)
    A  r <- r + dt/2 v
       f <- F(r)
    B  v <- v + dt/2 f

with ``xi(t)`` the noise of global step ``t`` (the start's step, then one
more each step), one normal a particle and axis:

    words  Philox4x32-10(counter (t mod 2^32, t >> 32, id, 0),
                         key (seed mod 2^32, (seed >> 32) mod 2^32))
    axis 0 r cos(2 pi u2), axis 1 r sin(2 pi u2), r = sqrt(-2 ln u1),
           u1 = (w0 + 1) 2^-32, u2 = w1 2^-32; in 3D axis 2 the cosine of
           the pair (w2, w3)

``id`` is the particle's row in the start state. Philox runs here in int64
over 32-bit values, each 32 x 32-bit product summed from products of
16-bit halves, so no product overflows.

Departures from the program:

- float64 throughout. The program runs float32 with Kahan-compensated
  positions; its Langevin window leaves velocities uncompensated.
- The Box-Muller transform from the words in float64 (``u1``, ``u2``
  exact); the program rounds ``u1`` and ``u2`` to float32 first, which
  moves a normal by ~1e-7 of itself (more where ``u1`` is within 2^-24 of
  1 and ``r`` near 0).
- The program's window fuses each step's closing B with the next step's
  opening B (one kick of dt, a half-kick at each end of a window) and its
  two A drifts into one of ``dt/2 (v + v')``: the same map in exact
  arithmetic.
- Forces over a pair list of every pair within ``cutoff + lj_nve.SKIN``,
  built anew when a particle has moved ``SKIN / 2``; the program's over its
  cell grid on its own rebuild gate: the same pairs inside the cutoff.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import lj_nve

# a float32 matrix product on the card may otherwise run in TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
LOW32 = (1 << 32) - 1
MULTIPLIERS = (0xD2511F53, 0xCD9E8D57)
KEY_BUMPS = (0x9E3779B9, 0xBB67AE85)


def _wide_product(x: torch.Tensor, m: int):
    """``(high, low)`` words of the 64-bit product of 32-bit values ``x``
    (int64) and ``m``."""
    x_lo, x_hi = x & 0xFFFF, x >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    low = x_lo * m_lo
    cross = x_hi * m_lo + x_lo * m_hi
    low_sum = low + ((cross & 0xFFFF) << 16)
    high = x_hi * m_hi + (cross >> 16) + (low_sum >> 32)
    return high, low_sum & LOW32


def philox(counter, key):
    """Philox4x32-10: four int64 tensors of 32-bit counter words and two key
    words (ints) in, the four output words out."""
    x0, x1, x2, x3 = counter
    k0, k1 = key[0] & LOW32, key[1] & LOW32
    for rnd in range(10):
        if rnd > 0:
            k0 = (k0 + KEY_BUMPS[0]) & LOW32
            k1 = (k1 + KEY_BUMPS[1]) & LOW32
        h0, l0 = _wide_product(x0, MULTIPLIERS[0])
        h1, l1 = _wide_product(x2, MULTIPLIERS[1])
        x0, x1, x2, x3 = h1 ^ x1 ^ k0, l1, h0 ^ x3 ^ k1, l0
    return x0, x1, x2, x3


def noise(seed: int, step: int, n: int, dim: int, device) -> torch.Tensor:
    """``(n, dim)`` float64 normals of global step ``step`` for the particles
    ``0 .. n-1``."""
    seed %= 1 << 64
    ids = torch.arange(n, dtype=torch.int64, device=device)
    fill = torch.zeros_like(ids)
    w = philox((fill + step % (1 << 32), fill + (step >> 32), ids, fill), (seed % (1 << 32), seed >> 32))
    scale = 2.0**-32

    def pair(a, b):
        u1 = (a.to(F64) + 1.0) * scale
        u2 = b.to(F64) * scale
        r = torch.sqrt(-2.0 * torch.log(u1))
        return r * torch.cos(2.0 * math.pi * u2), r * torch.sin(2.0 * math.pi * u2)

    z0, z1 = pair(w[0], w[1])
    cols = [z0, z1] if dim == 2 else [z0, z1, pair(w[2], w[3])[0]]
    return torch.stack(cols, dim=1)


def run(r0: torch.Tensor, v0: torch.Tensor, p: lj_nve.LJ, dt: float, steps: int, gamma: float, kt: float,
        seed: int, step0: int):
    """``steps`` BAOAB steps in float64 from ``(r0, v0)`` at global step
    ``step0`` under the stream seed ``seed``. Returns ``(r, v, ke, pe)``:
    positions wrapped into [0, box), velocities, kinetic and potential
    energy at the last step."""
    r = r0.to(F64)
    v = v0.to(F64)
    n, dim = r.shape
    c1 = math.exp(-gamma * dt)
    c2 = math.sqrt(kt * (1.0 - c1 * c1))
    rlist = p.cutoff + lj_nve.SKIN
    i, j = lj_nve.pair_list(r, p.box, rlist)
    r_built = r.clone()
    f = lj_nve.forces(r, i, j, p)
    for k in range(steps):
        v = v + 0.5 * dt * f
        r = r + 0.5 * dt * v
        v = c1 * v + c2 * noise(seed, step0 + k, n, dim, r.device)
        r = r + 0.5 * dt * v
        moved = lj_nve._min_image(r - r_built, p.box)
        if float((moved * moved).sum(1).max()) > (0.5 * lj_nve.SKIN) ** 2:
            i, j = lj_nve.pair_list(r, p.box, rlist)
            r_built = r.clone()
        f = lj_nve.forces(r, i, j, p)
        v = v + 0.5 * dt * f
    _, pe = lj_nve.forces(r, i, j, p, with_energy=True)
    ke = 0.5 * (v * v).sum()
    return torch.remainder(r, p.box), v, ke, pe
