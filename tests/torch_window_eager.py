"""The NVE leapfrog window and the BAOAB Langevin window as eager PyTorch
ops, the forms they had before each window's updates became one kernel
pass a step (``leapfrog_cuda.Leapfrog``, ``baoab_cuda.Baoab``): the
references that the tests hold the plain versions (CPU) and the kernels
(card) to, slot for slot. Imports no jax, so the card's tests can use it.

    window = eager_window(md, md.force_kernel, n_inner)
    window = eager_langevin_window(md, md.force_kernel, n_inner, (gamma, kT))
    s1 = window(s0)
"""

import math

import torch

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.noise_cuda import langevin_noise


def _kadd(x, c, inc):
    y = inc - c
    t = x + y
    c = (t - x) - y
    return t, c


def _sumsq(v):
    out = v[0] * v[0]
    for t in v[1:]:
        out = out + t * t
    return out


def eager_window(md, force_fn, n_inner: int):
    """``window(s) -> s``: ``n_inner`` NVE velocity-Verlet steps of the
    engine ``md`` (2D or 3D, its ``dt``, ``compensated``, ``skin`` and
    sharding hooks), one elementwise op at a time."""
    dt = md.dt
    comp = bool(md.compensated)
    axes = md.AXES

    def window(s):
        extra = md._force_args(s)
        f = [getattr(s, f"f{a}g") for a in axes]
        vh = [getattr(s, f"v{a}g") + 0.5 * dt * fa for a, fa in zip(axes, f)]
        pos = [getattr(s, f"{a}g") for a in axes]
        cr = [getattr(s, f"cr{a}") for a in axes]
        cv = [getattr(s, f"cv{a}") for a in axes]
        disp = [getattr(s, f"disp{a}") for a in axes]
        dm = _sumsq(disp)
        for _ in range(n_inner):
            inc = [dt * v for v in vh]
            for k in range(len(axes)):
                if comp:
                    pos[k], cr[k] = _kadd(pos[k], cr[k], inc[k])
                else:
                    pos[k] = pos[k] + inc[k]
                disp[k] = disp[k] + inc[k]
            dm = torch.maximum(dm, _sumsq(disp))
            f = list(force_fn(*pos, *extra))
            for k in range(len(axes)):
                if comp:
                    vh[k], cv[k] = _kadd(vh[k], cv[k], dt * f[k])
                else:
                    vh[k] = vh[k] + dt * f[k]
        dmax2 = md._all_max(torch.max(dm))
        violation = ~(dmax2 <= (0.5 * md.skin) ** 2)
        out = dict(dmax2=dmax2, overflow=s.overflow | violation, time=s.time + n_inner * dt)
        for k, a in enumerate(axes):
            out.update({
                f"{a}g": pos[k], f"v{a}g": vh[k] - 0.5 * dt * f[k], f"f{a}g": f[k],
                f"cr{a}": cr[k], f"cv{a}": cv[k], f"disp{a}": disp[k],
            })
        return s.replace(**out)

    return window


def eager_langevin_window(md, force_fn, n_inner: int, thermostat):
    """``window(s) -> s``: ``n_inner`` BAOAB Langevin steps of the engine
    ``md`` under ``thermostat=(gamma, kT)``, one elementwise op at a time
    beside one noise draw a step, the state's noise stream and global step
    carried as the engine's window carries them."""
    dt = md.dt
    comp = bool(md.compensated)
    axes = md.AXES
    gamma, kt_target = thermostat
    c1 = float(math.exp(-gamma * dt))
    c2 = float(math.sqrt(kt_target * (1.0 - c1 * c1)))

    def window(s):
        if s.rng_seed is None:
            raise ValueError("Langevin window needs a PRNG stream: init(..., seed=...)")
        extra = md._force_args(s)
        f = [getattr(s, f"f{a}g") for a in axes]
        vh = [getattr(s, f"v{a}g") + 0.5 * dt * fa for a, fa in zip(axes, f)]
        pos = [getattr(s, f"{a}g") for a in axes]
        cr = [getattr(s, f"cr{a}") for a in axes]
        disp = [getattr(s, f"disp{a}") for a in axes]
        dm = _sumsq(disp)
        for i in range(n_inner):
            # A O A: drift half on vh, OU-refresh vh, drift half on the
            # refreshed vh; the increments fuse into one add
            xi = langevin_noise(s.rng_seed, s.rng_counter + i, s.pid, len(axes), s.xg.dtype)
            vp = [c1 * v + c2 * xi[k] for k, v in enumerate(vh)]
            inc = [0.5 * dt * (v + p) for v, p in zip(vh, vp)]
            vh = vp
            for k in range(len(axes)):
                if comp:
                    pos[k], cr[k] = _kadd(pos[k], cr[k], inc[k])
                else:
                    pos[k] = pos[k] + inc[k]
                disp[k] = disp[k] + inc[k]
            dm = torch.maximum(dm, _sumsq(disp))
            f = list(force_fn(*pos, *extra))
            vh = [v + dt * fa for v, fa in zip(vh, f)]
        v = [v - 0.5 * dt * fa for v, fa in zip(vh, f)]
        dmax2 = md._all_max(torch.max(dm))
        violation = ~(dmax2 <= (0.5 * md.skin) ** 2)
        out = dict(dmax2=dmax2, overflow=s.overflow | violation, time=s.time + n_inner * dt,
                   rng_counter=s.rng_counter + n_inner)
        for k, a in enumerate(axes):
            out.update({f"{a}g": pos[k], f"v{a}g": v[k], f"f{a}g": f[k], f"disp{a}": disp[k]})
            if comp:
                out[f"cr{a}"] = cr[k]
        return s.replace(**out, **md._stepped(s, n_inner))

    return window


def window_fields(md):
    """The state fields a window writes, for ``md``'s axes."""
    return [f"{p}{a}{g}" for a in md.AXES for p, g in (("", "g"), ("v", "g"), ("f", "g"), ("cr", ""), ("cv", ""),
                                                        ("disp", ""))] + ["dmax2", "overflow", "time"]


def assert_states_equal(md, got, want) -> None:
    """Every field a window writes, ``torch.equal`` (None where both are)."""
    for name in window_fields(md):
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            assert a is None and b is None, name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name
