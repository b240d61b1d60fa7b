"""The Langevin windows' noise: counter-based, keyed by particle and step.

Replaces no TPU kernel (the JAX package draws from ``jax.random`` with
folded keys). The noise of particle ``p``, axis ``k``, at global step ``t``
under the stream seed ``seed`` is a pure function of the four:

- words: one Philox4x32-10 call (Salmon et al., SC'11; Random123's
  ``philox4x32_10``, cuRAND's ``curand_Philox4x32_10``) with counter
  ``(t mod 2^32, t >> 32, p, 0)`` and key ``(seed mod 2^32, (seed >> 32)
  mod 2^32)``, giving four 32-bit words ``w0..w3``;
- normals: Box-Muller on two words a pair, ``u1 = (w0 + 1) 2^-32``, ``u2 =
  w1 2^-32``, ``r = sqrt(-2 ln u1)``, axis 0 ``r cos(2 pi u2)``, axis 1 ``r
  sin(2 pi u2)``; in 3D axis 2 is ``r' cos(2 pi u2')`` from ``w2, w3``.

So a particle's kicks do not depend on the grid slot it holds, on the
device, on the rank that holds it, or on how its steps are cut into
windows, blocks and phases; a plain reference replays them from the ids.
The card's kernel (``csrc/noise.cu``, whose header gives what bounds it)
evaluates ``u1``, ``u2`` in float32 and the rest with the accurate ``logf``,
``sqrtf`` and ``sincospif``.

- :func:`philox4x32_10`: the words, plain PyTorch over int64 tensors of
  32-bit values (each 32 x 32-bit product built from 16-bit halves, so no
  int64 product overflows);
- :func:`noise_reference`: the plain version of the kernel, ``u1`` and
  ``u2`` in float32 as the kernel rounds them, the rest in float64, one
  rounding to the output dtype;
- :func:`langevin_noise`: the ``(dim,) + pid.shape`` noise of the grid slots
  whose particle ids are ``pid``, exactly 0 where ``pid < 0`` (empty
  slots). CPU tensors take the plain version, CUDA tensors launch the
  kernel (float32) or raise;
- ``LAUNCHES``: noise kernel launches (one a Langevin step on the card).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

LAUNCHES = 0

M32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85  # key bumps
ROUNDS = 10
TWO_POW_MINUS_32 = 2.0**-32


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``m * x`` for a 32-bit constant ``m``
    and an int64 tensor of 32-bit values, from 16-bit halves."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = xh * ml + xl * mh  # < 2^33
    lo = xl * ml + ((mid & 0xFFFF) << 16)  # < 2^33
    return xh * mh + (mid >> 16) + (lo >> 32), lo & M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """The four output words of Philox4x32-10 for counter words ``c0..c3``
    (int64 tensors of 32-bit values, broadcast together) and key words
    ``k0``, ``k1``."""
    k0, k1 = k0 & M32, k1 & M32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & M32, (k1 + PHILOX_W1) & M32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _sincospi(x: torch.Tensor):
    """``(sin(pi x), cos(pi x))`` of float64 ``x`` (multiples of 2^-31 in
    [0, 2)) with the quadrant taken off exactly, as ``sincospif`` does: the
    half-integers give exact zeros."""
    q = torch.round(2.0 * x)
    y = math.pi * (x - 0.5 * q)  # |x - q/2| <= 1/4, exact
    s, c = torch.sin(y), torch.cos(y)
    q = q.long() % 4
    sin = torch.where(q == 0, s, torch.where(q == 1, c, torch.where(q == 2, -s, -c)))
    cos = torch.where(q == 0, c, torch.where(q == 1, -s, torch.where(q == 2, -c, s)))
    return sin, cos


def _pair(a: torch.Tensor, b: torch.Tensor):
    """Box-Muller of the words ``(a, b)``: ``(r cos, r sin)`` in float64,
    ``u1`` and ``u2`` rounded to float32 first as the kernel rounds them."""
    u1 = (a.to(torch.float32) + 1.0) * TWO_POW_MINUS_32
    u2 = b.to(torch.float32) * TWO_POW_MINUS_32
    r = torch.sqrt(-2.0 * torch.log(u1.double()))
    sin, cos = _sincospi(2.0 * u2.double())
    return r * cos, r * sin


def _key(seed: int):
    seed &= (1 << 64) - 1
    return seed & M32, seed >> 32


def _check_step(step: int) -> int:
    step = int(step)
    if not 0 <= step < (1 << 64):
        raise ValueError(f"step {step} must lie in [0, 2^64)")
    return step


def noise_reference(seed: int, step: int, pid: torch.Tensor, dim: int, dtype=torch.float32) -> torch.Tensor:
    """Plain version of the kernel: the ``(dim,) + pid.shape`` noise, 0
    where ``pid < 0``."""
    step = _check_step(step)
    k0, k1 = _key(seed)
    p = pid.long()
    occupied = p >= 0
    zero = torch.zeros_like(p)
    w = philox4x32_10(zero + (step & M32), zero + (step >> 32), p.clamp(min=0), zero, k0, k1)
    z0, z1 = _pair(w[0], w[1])
    axes = [z0, z1] if dim == 2 else [z0, z1, _pair(w[2], w[3])[0]]
    return torch.stack([torch.where(occupied, z, torch.zeros_like(z)) for z in axes]).to(dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_langevin_noise
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def langevin_noise(seed: int, step: int, pid: torch.Tensor, dim: int, dtype=torch.float32) -> torch.Tensor:
    """The noise of global step ``step`` for the grid slots whose int32
    particle ids are ``pid``: a new ``(dim,) + pid.shape`` tensor of
    ``dtype``, exactly 0 where ``pid < 0``."""
    global LAUNCHES
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if pid.dtype != torch.int32:
        raise TypeError(f"pid: expected int32 particle ids, got {pid.dtype}")
    if not pid.is_contiguous():
        raise ValueError("pid: expected a contiguous tensor")
    if pid.device.type == "cpu":
        return noise_reference(seed, step, pid, dim, dtype)
    if pid.device.type != "cuda":
        raise ValueError(f"langevin_noise runs on cpu or cuda tensors, not {pid.device}")
    if dtype != torch.float32:
        raise TypeError(f"the noise kernel writes float32, not {dtype}")
    step = _check_step(step)
    k0, k1 = _key(seed)
    out = torch.empty((dim,) + tuple(pid.shape), dtype=torch.float32, device=pid.device)
    status = _launcher()(
        pid.data_ptr(), out.data_ptr(), pid.numel(), dim, k0, k1, step & M32, step >> 32,
        pid.device.index, torch.cuda.current_stream(pid.device).cuda_stream,
    )
    _build.check(status, "noise kernel")
    LAUNCHES += 1
    return out
