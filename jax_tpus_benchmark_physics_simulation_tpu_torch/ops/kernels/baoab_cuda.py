"""The BAOAB Langevin window's elementwise updates: one kernel pass a step.

Replaces no TPU kernel. The JAX package's Langevin window
(``grid_md._make_window``) leaves its kicks, Ornstein-Uhlenbeck refresh,
drifts, Kahan position residuals and displacement max to XLA, which fuses
them; in eager PyTorch they were ~30 elementwise launches a 2D Kahan step.
Here a window of ``n`` steps is ``n`` step launches and one closing launch
of ``csrc/baoab.cu``, whose header gives the arithmetic, what bounds it on
an H100 (bytes: 20 planes a 2D Kahan step) and how the running max of
``|disp|^2`` becomes one device scalar. Each step's noise is the noise
kernel's launch (``noise_cuda.langevin_noise``), read here as ``xi``.

- :class:`Baoab`: one window's planes. ``step(f, xi)`` kicks with ``f``
  (the half-kick in on the window's first step), then refreshes the
  velocity with the noise ``xi`` and drifts; ``close(f)``, once after the
  steps, kicks and half-unkicks out, after which ``v``, ``pos``, ``cr``,
  ``disp`` and ``dmax2`` are the window's results. CPU planes take the
  plain version, the eager ops of the window in their order (a per-slot
  ``torch.maximum`` plane and one ``torch.max``); float32 CUDA planes launch
  the kernel or raise. Nothing the window was given is written: a field's
  first write goes to a new buffer, later ones in place;
- ``STEP_LAUNCHES`` / ``CLOSE_LAUNCHES``: kernel launches, counted where
  :class:`Baoab` launches them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.leapfrog_cuda import _check, kadd, sumsq

STEP_LAUNCHES = 0
CLOSE_LAUNCHES = 0

_FIRST, _STEP, _CLOSE = 0, 1, 2  # Mode in csrc/baoab.cu
_MAX_DIM = 3  # kMaxDim
# Field in csrc/baoab.cu: (f, xi, v in, v out, pos in, pos out, cr in, cr
# out, disp in, disp out), _MAX_DIM pointers each
_FIELDS = 10


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_baoab
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Baoab:
    """One Langevin window's BAOAB updates over ``dim`` (2 or 3) axes of
    grid planes: the state's velocity ``v``, position ``pos`` and
    displacement since the rebuild ``disp``, and with Kahan compensation
    the position residual ``cr``. ``dt`` is the step, ``c1`` and ``c2`` the
    Ornstein-Uhlenbeck map's ``vh <- c1 vh + c2 xi``."""

    def __init__(self, v, pos, disp, cr=None, *, dt: float, c1: float, c2: float):
        pos = list(pos)
        if not 2 <= len(pos) <= _MAX_DIM:
            raise ValueError(f"pos: expected 2 or 3 planes, got {len(pos)}")
        like = pos[0]
        dim = len(pos)
        if like.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the BAOAB updates run on cpu or cuda tensors, not {like.device}")
        if not like.dtype.is_floating_point:
            raise TypeError(f"pos: expected floating-point planes, got {like.dtype}")
        if like.device.type == "cuda" and like.dtype != torch.float32:
            raise TypeError(f"the BAOAB kernel takes float32 planes, got {like.dtype}")
        self.dim = dim
        self.dt, self.c1, self.c2 = dt, c1, c2
        self.compensated = cr is not None
        self.on_card = like.device.type == "cuda"
        self._like = like
        self.v = _check("v", v, like, dim)
        self.pos = _check("pos", pos, like, dim)
        self.disp = _check("disp", disp, like, dim)
        self.cr = _check("cr", cr, like, dim) if self.compensated else None
        self.dmax2: Optional[torch.Tensor] = None
        self._steps = 0
        self._dm = None  # the plain version's per-slot running max
        self._ptrs = None  # the kernel's pointer array, _FIELDS x _MAX_DIM

    # -- the window's launches ------------------------------------------------
    def step(self, f, xi) -> None:
        """Kick with ``f`` (the state's force on the first step: the
        half-kick in), refresh the velocity with the step's noise ``xi``
        (``dim`` planes, as ``noise_cuda.langevin_noise`` gives them), then
        drift; the displacement max takes the new ``disp``."""
        f = _check("f", f, self._like, self.dim)
        xi = _check("xi", xi, self._like, self.dim)
        if self.on_card:
            self._launch(_FIRST if self._steps == 0 else _STEP, f, xi)
        else:
            self._plain_step(f, xi)
        self._steps += 1

    def close(self, f) -> None:
        """The last step's kick with its force ``f``, then the half-unkick
        out: ``v`` is the window's velocity."""
        f = _check("f", f, self._like, self.dim)
        if self.on_card:
            self._launch(_CLOSE, f)
        else:
            self._kick(f)
            self.v = [v - 0.5 * self.dt * fa for v, fa in zip(self.v, f)]
            self.dmax2 = torch.max(self._dm)

    # -- plain version: the eager ops, in their order --------------------------
    def _kick(self, f) -> None:
        self.v = [v + self.dt * fa for v, fa in zip(self.v, f)]

    def _plain_step(self, f, xi) -> None:
        dt = self.dt
        if self._steps == 0:
            self.v = [v + 0.5 * dt * fa for v, fa in zip(self.v, f)]
            self._dm = sumsq(self.disp)
        else:
            self._kick(f)
        # A O A: drift half on vh, OU-refresh vh, drift half on the
        # refreshed vh; the increments fuse into one add
        vp = [self.c1 * v + self.c2 * xi[k] for k, v in enumerate(self.v)]
        inc = [0.5 * dt * (v + p) for v, p in zip(self.v, vp)]
        self.v = vp
        for k in range(self.dim):
            if self.compensated:
                self.pos[k], self.cr[k] = kadd(self.pos[k], self.cr[k], inc[k])
            else:
                self.pos[k] = self.pos[k] + inc[k]
            self.disp[k] = self.disp[k] + inc[k]
        self._dm = torch.maximum(self._dm, sumsq(self.disp))

    # -- the kernel --------------------------------------------------------------
    def _bind(self, mode: int, f, xi) -> ctypes.Array:
        """The pointer array of this launch. The window's first launch moves
        its fields onto buffers of its own and the second reads and writes
        them in place, each building the array anew; from the third on only
        ``f``'s and ``xi``'s pointers change."""
        if self._steps > 1:
            for k in range(self.dim):
                self._ptrs[k] = f[k].data_ptr()
                if xi is not None:
                    self._ptrs[_MAX_DIM + k] = xi[k].data_ptr()
            return self._ptrs
        ins = (self.v, self.pos, self.cr, self.disp)
        if mode == _FIRST:
            # the window's own buffers: nothing it was given is written
            like = self._like
            n = 4 if self.compensated else 3
            planes = torch.empty((n * self.dim,) + tuple(like.shape), dtype=like.dtype,
                                 device=like.device).unbind(0)
            fresh = [list(planes[i * self.dim : (i + 1) * self.dim]) for i in range(n)]
            self.v, self.pos, self.disp = fresh[:3]
            if self.compensated:
                self.cr = fresh[3]
            self.dmax2 = torch.empty((), dtype=like.dtype, device=like.device)
        outs = (self.v, self.pos, self.cr, self.disp)
        ptrs = []
        for planes in (f, xi) + tuple(p for pair in zip(ins, outs) for p in pair):
            got = [p.data_ptr() for p in planes or ()]
            ptrs += got + [None] * (_MAX_DIM - len(got))
        self._ptrs = (ctypes.c_void_p * (_FIELDS * _MAX_DIM))(*ptrs)
        return self._ptrs

    def _launch(self, mode: int, f, xi: Optional[List[torch.Tensor]] = None) -> None:
        global STEP_LAUNCHES, CLOSE_LAUNCHES
        ptrs = self._bind(mode, f, xi)
        device = self._like.device
        status = _launcher()(
            mode, self.dim, int(self.compensated), ptrs, self._like.numel(),
            self.c1, self.c2, self.dt, 0.5 * self.dt, self.dmax2.data_ptr(), device.index,
            torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(status, "BAOAB kernel")
        if mode == _CLOSE:
            CLOSE_LAUNCHES += 1
        else:
            STEP_LAUNCHES += 1
