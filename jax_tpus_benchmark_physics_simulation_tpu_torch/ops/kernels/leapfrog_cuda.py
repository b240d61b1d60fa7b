"""The NVE leapfrog window's elementwise updates: one kernel pass a step.

Replaces no TPU kernel. The JAX package's window (``grid_md._make_window``)
leaves its kick, drift, Kahan residuals and displacement max to XLA, which
fuses them; in eager PyTorch they were ~26 elementwise launches a 2D step.
Here a window of ``n`` steps is ``n`` step launches and one closing launch
of ``csrc/leapfrog.cu``, whose header gives the arithmetic, what bounds it
on an H100 (bytes: 22 planes a 2D Kahan step) and how the running max of
``|disp|^2`` becomes one device scalar.

- :class:`Leapfrog`: one window's planes. ``step(f)`` kicks with ``f`` (the
  half-kick in on the window's first step) and drifts; ``close(f)``, once
  after the steps, kicks and half-unkicks out, after which ``v``, ``pos``,
  ``cr``, ``cv``, ``disp`` and ``dmax2`` are the window's results. CPU
  planes take the plain version, the eager ops of the window in their
  order (:func:`kadd` and :func:`sumsq`, which the engine's Langevin
  window shares, a per-slot ``torch.maximum`` plane and one
  ``torch.max``); float32 CUDA planes launch the kernel or raise.
  Nothing the window was given is written: a field's first write goes to
  a new buffer, later ones in place;
- ``STEP_LAUNCHES`` / ``CLOSE_LAUNCHES``: kernel launches, counted where
  :class:`Leapfrog` launches them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import _build

STEP_LAUNCHES = 0
CLOSE_LAUNCHES = 0

_FIRST, _STEP, _CLOSE = 0, 1, 2  # Mode in csrc/leapfrog.cu
_MAX_DIM = 3  # kMaxDim
# Field in csrc/leapfrog.cu: (f, v in, v out, pos in, pos out, cr in, cr out,
# cv in, cv out, disp in, disp out), _MAX_DIM pointers each
_FIELDS = 11


def kadd(x, c, inc):
    """Kahan-compensated ``x += inc`` with residual ``c``. Kept as separate
    eager ops: an algebraic simplification would cancel the residual."""
    y = inc - c
    t = x + y
    c = (t - x) - y
    return t, c


def sumsq(v):
    """``v[0]^2 + v[1]^2 (+ v[2]^2)``, as separate eager ops."""
    out = v[0] * v[0]
    for t in v[1:]:
        out = out + t * t
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library().jtps_leapfrog
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, planes: Sequence[torch.Tensor], like: torch.Tensor, dim: int) -> List[torch.Tensor]:
    """``planes`` as a list of ``dim`` contiguous planes of ``like``'s shape,
    dtype and device."""
    planes = list(planes)
    if len(planes) != dim:
        raise ValueError(f"{name}: expected {dim} planes, got {len(planes)}")
    for p in planes:
        if p.device != like.device:
            raise ValueError(f"{name}: a plane on {p.device}, expected {like.device}")
        if p.dtype != like.dtype:
            raise TypeError(f"{name}: a {p.dtype} plane, expected {like.dtype}")
        if p.shape != like.shape:
            raise ValueError(f"{name}: a plane of shape {tuple(p.shape)}, expected {tuple(like.shape)}")
        if not p.is_contiguous():
            raise ValueError(f"{name}: expected contiguous planes")
    return planes


class Leapfrog:
    """One NVE window's velocity-Verlet updates over ``dim`` (2 or 3) axes
    of grid planes: the state's velocity ``v``, position ``pos`` and
    displacement since the rebuild ``disp``, and with Kahan compensation
    the position and velocity residuals ``cr`` and ``cv`` (both or
    neither). ``dt`` is the step."""

    def __init__(self, v, pos, disp, cr=None, cv=None, *, dt: float):
        pos = list(pos)
        if not 2 <= len(pos) <= _MAX_DIM:
            raise ValueError(f"pos: expected 2 or 3 planes, got {len(pos)}")
        like = pos[0]
        dim = len(pos)
        if like.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the leapfrog updates run on cpu or cuda tensors, not {like.device}")
        if not like.dtype.is_floating_point:
            raise TypeError(f"pos: expected floating-point planes, got {like.dtype}")
        if like.device.type == "cuda" and like.dtype != torch.float32:
            raise TypeError(f"the leapfrog kernel takes float32 planes, got {like.dtype}")
        if (cr is None) != (cv is None):
            raise ValueError("cr and cv: give both residuals (compensated) or neither")
        self.dim = dim
        self.dt = dt
        self.compensated = cr is not None
        self.on_card = like.device.type == "cuda"
        self._like = like
        self.v = _check("v", v, like, dim)
        self.pos = _check("pos", pos, like, dim)
        self.disp = _check("disp", disp, like, dim)
        self.cr = _check("cr", cr, like, dim) if self.compensated else None
        self.cv = _check("cv", cv, like, dim) if self.compensated else None
        self.dmax2: Optional[torch.Tensor] = None
        self._steps = 0
        self._dm = None  # the plain version's per-slot running max
        self._ptrs = None  # the kernel's pointer array, _FIELDS x _MAX_DIM

    # -- the window's launches ------------------------------------------------
    def step(self, f) -> None:
        """Kick with ``f`` (the state's force on the first step: the
        half-kick in), then drift; the displacement max takes the new
        ``disp``."""
        f = _check("f", f, self._like, self.dim)
        if self.on_card:
            self._launch(_FIRST if self._steps == 0 else _STEP, f)
        else:
            self._plain_step(f)
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
        dt = self.dt
        for k in range(self.dim):
            if self.compensated:
                self.v[k], self.cv[k] = kadd(self.v[k], self.cv[k], dt * f[k])
            else:
                self.v[k] = self.v[k] + dt * f[k]

    def _plain_step(self, f) -> None:
        dt = self.dt
        if self._steps == 0:
            self.v = [v + 0.5 * dt * fa for v, fa in zip(self.v, f)]
            self._dm = sumsq(self.disp)
        else:
            self._kick(f)
        inc = [dt * v for v in self.v]
        for k in range(self.dim):
            if self.compensated:
                self.pos[k], self.cr[k] = kadd(self.pos[k], self.cr[k], inc[k])
            else:
                self.pos[k] = self.pos[k] + inc[k]
            self.disp[k] = self.disp[k] + inc[k]
        self._dm = torch.maximum(self._dm, sumsq(self.disp))

    # -- the kernel --------------------------------------------------------------
    def _fresh(self, n_fields: int) -> List[List[torch.Tensor]]:
        """``n_fields`` new fields of ``dim`` planes, from one allocation."""
        like = self._like
        planes = torch.empty((n_fields * self.dim,) + tuple(like.shape), dtype=like.dtype,
                             device=like.device).unbind(0)
        return [list(planes[i * self.dim : (i + 1) * self.dim]) for i in range(n_fields)]

    def _bind(self, mode: int, f) -> ctypes.Array:
        """The pointer array of this launch. The first three launches of a
        window move its fields onto buffers of its own (``cv``'s on its
        first kick) and build the array anew; from the third on, every
        field is read and written in place, and only ``f``'s pointers
        change."""
        if self._steps > 2:
            for k, p in enumerate(f):
                self._ptrs[k] = p.data_ptr()
            return self._ptrs
        comp = self.compensated
        ins = (self.v, self.pos, self.cr, self.cv, self.disp)
        if mode == _FIRST:
            # the window's own buffers: nothing it was given is written
            fresh = self._fresh(4 if comp else 3)
            self.v, self.pos, self.disp = fresh[:3]
            if comp:
                self.cr = fresh[3]
            self.dmax2 = torch.empty((), dtype=self._like.dtype, device=self._like.device)
        elif comp and self._steps == 1:  # the window's first kick writes cv
            self.cv = self._fresh(1)[0]
        outs = (self.v, self.pos, self.cr, self.cv, self.disp)
        ptrs = []
        for planes in (f,) + tuple(p for pair in zip(ins, outs) for p in pair):
            got = [p.data_ptr() for p in planes or ()]
            ptrs += got + [None] * (_MAX_DIM - len(got))
        self._ptrs = (ctypes.c_void_p * (_FIELDS * _MAX_DIM))(*ptrs)
        return self._ptrs

    def _launch(self, mode: int, f) -> None:
        global STEP_LAUNCHES, CLOSE_LAUNCHES
        ptrs = self._bind(mode, f)
        device = self._like.device
        status = _launcher()(
            mode, self.dim, int(self.compensated), ptrs, self._like.numel(),
            self.dt, 0.5 * self.dt, self.dmax2.data_ptr(), device.index,
            torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(status, "leapfrog kernel")
        if mode == _CLOSE:
            CLOSE_LAUNCHES += 1
        else:
            STEP_LAUNCHES += 1
