"""The port's VMC -> DMC quantum oscillator (``mc/*``,
``models/quantum_oscillator.py``, ``utils/{debug, prng}.py`` and the CLI's
``vmc``) against the JAX package on the CPU.

The deterministic pieces are fed the same inputs: walkers from numpy seeds,
and for the Metropolis update, the resamplers and a DMC step the uniforms
and normals JAX itself draws from the same key splits. Where bit equality
fails it is for a named op, held at rtol 1e-6 (float32):

- XLA on the CPU contracts ``a * b + c`` into a fused multiply-add where it
  can (the proposal ``w + step * u``, Adam's moments, the DMC move);
- reductions (``sum``, ``mean``, the ``tensordot`` over walkers, ``cumsum``)
  add in another order than PyTorch's; a sum of terms of both signs is held
  to 1e-6 of the sum of their magnitudes;
- ``exp`` and XLA's float32 ``pow`` (Adam's ``b**count``) can differ by an
  ulp.

So a resampled index is compared only where its comb point lies farther
than 1e-6 from a CDF step, a Metropolis accept only where |u - exp(2 delta
log psi)| > 1e-6; the near-ties are counted and shown to be the only
mismatches. Whole runs draw from ``torch.Generator`` streams, not
``jax.random``, so they are held to the physics bounds of JAX's own
``tests/test_mc.py``.
"""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.core.config import VMCDMCConfig as JaxVMCDMCConfig
from jax_tpus_benchmark_physics_simulation_tpu.core.config import override as jax_override
from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState as JaxParticleState
from jax_tpus_benchmark_physics_simulation_tpu.mc import dmc as jdmc
from jax_tpus_benchmark_physics_simulation_tpu.mc import metropolis as jmet
from jax_tpus_benchmark_physics_simulation_tpu.mc import models as jmodels
from jax_tpus_benchmark_physics_simulation_tpu.mc import resampling as jres
from jax_tpus_benchmark_physics_simulation_tpu.mc import vmc as jvmc
from jax_tpus_benchmark_physics_simulation_tpu.utils import debug as jdebug
from jax_tpus_benchmark_physics_simulation_tpu_torch import cli
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import VMCDMCConfig, override
from jax_tpus_benchmark_physics_simulation_tpu_torch.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import adam_state_from_jax, mc_params_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc import (
    HarmonicOscillator,
    generic_local_energy,
    run_dmc,
    run_vmc,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.mc import adam, dmc, metropolis, models, resampling, vmc
from jax_tpus_benchmark_physics_simulation_tpu_torch.models import quantum_oscillator
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils import debug
from jax_tpus_benchmark_physics_simulation_tpu_torch.utils.prng import make_generator

RTOL = 1e-6
TIE = 1e-6  # a comb point or accept draw this close to its threshold is a near-tie
ANH_PARAMS = {"alpha": 0.6, "beta": 0.05}


def _walkers(seed: int, n: int, dim: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(n, dim)) * scale).astype(np.float32)


def _models(kind: str, dim: int):
    """``(jax_model, port_model, jax_params, port_params)``."""
    if kind == "harmonic":
        p = np.float32(0.37)
        return (jmodels.HarmonicOscillator(dim=dim), models.HarmonicOscillator(dim=dim), jnp.asarray(p),
                mc_params_from_jax(p, "cpu"))
    p = {k: np.float32(v) for k, v in ANH_PARAMS.items()}
    return (jmodels.AnharmonicOscillator(dim=dim, lam=0.3), models.AnharmonicOscillator(dim=dim, lam=0.3),
            {k: jnp.asarray(v) for k, v in p.items()}, mc_params_from_jax(p, "cpu"))


def _close(got, want, rtol=RTOL, atol_scale=None):
    want = np.asarray(want)
    atol = rtol * (np.abs(want).max() if atol_scale is None else atol_scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


# -- models ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["harmonic", "anharmonic"])
@pytest.mark.parametrize("dim", [1, 3])
def test_model_functions_match_jax(kind, dim):
    """``log_psi``, ``potential``, ``local_energy`` (closed form, or
    ``torch.func`` over the dict params) and ``drift_force`` on seeded
    walkers; sums over the coordinates at rtol 1e-6."""
    jm, tm, jp, tp = _models(kind, dim)
    x = _walkers(dim, 256, dim, 1.3)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(tm.log_psi(tp, tx).numpy(), jm.log_psi(jp, jx))
    _close(tm.potential(tx).numpy(), jm.potential(jx))
    _close(tm.local_energy(tp, tx).numpy(), jm.local_energy(jp, jx))
    _close(tm.drift_force(tp, tx).numpy(), jm.drift_force(jp, jx))
    assert tm.exact_energy() == pytest.approx(jm.exact_energy(), rel=1e-15)
    assert tm.exact_params() == jm.exact_params()


def test_local_energy_constant_at_exact_alpha():
    """alpha = 0.5 is exact: E_L(x) = D/2 for every x (zero variance)."""
    x = torch.from_numpy(_walkers(0, 100, 3))
    e = HarmonicOscillator(dim=3).local_energy(torch.tensor(0.5), x)
    np.testing.assert_allclose(e.numpy(), 1.5, rtol=1e-5)


def test_generic_local_energy_harmonic_closed_form_and_jax():
    """The autodiff E_L of the harmonic trial equals its closed form and
    JAX's autodiff E_L (rtol 1e-6: the Laplacian's trace and |g|^2 sums)."""
    tm, jm = HarmonicOscillator(dim=3), jmodels.HarmonicOscillator(dim=3)
    x = _walkers(1, 50, 3)
    alpha = np.float32(0.37)
    e_auto = torch.func.vmap(generic_local_energy(tm.log_psi, tm.potential), in_dims=(None, 0))(
        torch.tensor(alpha), torch.from_numpy(x))
    np.testing.assert_allclose(e_auto.numpy(), tm.local_energy(torch.tensor(alpha), torch.from_numpy(x)).numpy(),
                               rtol=1e-5)
    j_auto = jax.vmap(jmodels.generic_local_energy(jm.log_psi, jm.potential), in_axes=(None, 0))(
        jnp.asarray(alpha), jnp.asarray(x))
    _close(e_auto.numpy(), j_auto)


def test_anharmonic_local_energy_hand_derived():
    """For log psi = -a r^2 - b sum x^4: grad_i = -2a x_i - 4b x_i^3,
    lap = sum(-2a - 12 b x_i^2) (JAX's test_mc, same tolerance)."""
    m = models.AnharmonicOscillator(dim=2, lam=0.3)
    params = m.init_params(0.6, device="cpu")
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in params.values())
    x = torch.from_numpy(_walkers(0, 64, 2))
    a, b = params["alpha"], params["beta"]
    g = -2 * a * x - 4 * b * x**3
    lap = torch.sum(-2 * a - 12 * b * x**2, dim=-1)
    v = 0.5 * torch.sum(x**2, dim=-1) + 0.3 * torch.sum(x**4, dim=-1)
    np.testing.assert_allclose(m.local_energy(params, x).numpy(),
                               (-0.5 * (lap + torch.sum(g * g, dim=-1)) + v).numpy(), rtol=1e-5)


def test_anharmonic_ground_state_equal_to_jax():
    e = {lam: models.anharmonic_ground_state_1d(lam) for lam in (0.0, 0.2, 0.3)}
    for lam in (0.0, 0.2):
        assert e[lam] == jmodels.anharmonic_ground_state_1d(lam)
    assert abs(e[0.0] - 0.5) < 1e-4 and e[0.3] > e[0.2]


# -- Metropolis -------------------------------------------------------------------


def _jax_sweep_draws(key, n: int, dim: int):
    """The uniforms JAX's sweep draws from ``key`` (mc/metropolis.py:29-34)."""
    k_prop, k_accept = jax.random.split(key)
    u_prop = jax.random.uniform(k_prop, (n, dim), dtype=jnp.float32, minval=-0.5, maxval=0.5)
    u_acc = jax.random.uniform(k_accept, (n,), dtype=jnp.float32)
    return np.array(u_prop), np.array(u_acc)


@pytest.mark.parametrize("kind", ["harmonic", "anharmonic"])
def test_metropolis_update_with_jax_draws(kind):
    """``metropolis_update`` fed JAX's own uniforms against JAX's sweep:
    every accept agrees except at near-ties of |u - exp(2 delta log psi)|,
    and the new walkers agree at rtol 1e-6 (the proposal ``w + step * u``,
    an FMA in XLA)."""
    dim, n, step = 3, 4000, 2.0
    jm, tm, jp, tp = _models(kind, dim)
    x = _walkers(5, n, dim)
    key = jax.random.PRNGKey(7)
    j_new, j_rate = jmet.make_metropolis_sweep(jm.log_psi, step)(jnp.asarray(x), jp, key)
    u_prop, u_acc = _jax_sweep_draws(key, n, dim)
    update = metropolis.make_metropolis_update(tm.log_psi, step)
    t_new, t_rate = update(torch.from_numpy(x), tp, torch.from_numpy(u_prop), torch.from_numpy(u_acc))
    j_new = np.asarray(j_new)
    j_acc = np.any(j_new != x, axis=1)
    t_acc = np.any(t_new.numpy() != x, axis=1)
    # the threshold exp(2 delta log psi), from the port's proposal
    prop = torch.from_numpy(x) + step * torch.from_numpy(u_prop)
    thr = torch.exp(2.0 * (tm.log_psi(tp, prop) - tm.log_psi(tp, torch.from_numpy(x)))).numpy()
    tie = np.abs(u_acc - thr) <= TIE
    assert np.all((j_acc == t_acc) | tie), np.flatnonzero((j_acc != t_acc) & ~tie)
    assert 0.1 < j_acc.mean() < 0.9
    keep = ~tie
    _close(t_new.numpy()[keep], j_new[keep])
    n_ties = int(tie.sum())
    assert abs(float(t_rate) - float(j_rate)) <= (n_ties + 0.5) / n


def test_sweep_draws_and_equilibrate_sample_the_density():
    """The port's own sweep on |psi|^2 = exp(-2 alpha x^2): Var = 1/(4 alpha)
    (JAX's test_mc bound), acceptance a 0-d tensor, no host read."""
    m = HarmonicOscillator(dim=1)
    sweep = metropolis.make_metropolis_sweep(m.log_psi, 2.0)
    gen = make_generator(3, "cpu")
    w = torch.randn((20000, 1), generator=gen)
    w, acc = metropolis.equilibrate(sweep, w, torch.tensor(0.5), gen, 200)
    assert acc.shape == () and isinstance(acc, torch.Tensor)
    np.testing.assert_allclose(float(torch.var(w)), 1.0 / (4 * 0.5), rtol=0.05)
    assert 0.1 < float(acc) < 0.9


# -- resampling -------------------------------------------------------------------


def _dmc_weights(seed: int, n: int, dt: float) -> np.ndarray:
    """DMC branching weights exp(-(E_L - <E_L>) dt) of seeded walkers."""
    x = _walkers(seed, n, 3, 1.2)
    e = np.asarray(jmodels.HarmonicOscillator(dim=3).local_energy(jnp.float32(0.45), jnp.asarray(x)))
    return np.exp(-(e - e.mean()) * dt).astype(np.float32)


def _near_ties(weights: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Points within ``TIE`` of a step of the (JAX) CDF of ``weights``."""
    cdf = np.asarray(jnp.cumsum(jres._sanitize(jnp.asarray(weights))))
    pos = np.clip(np.searchsorted(cdf, points), 1, len(cdf) - 1)
    return np.minimum(np.abs(points - cdf[pos - 1]), np.abs(points - cdf[pos])) <= TIE


@pytest.mark.parametrize("resampler", ["multinomial", "systematic"])
@pytest.mark.parametrize("dt", [0.01, 0.5])
def test_resamplers_with_jax_draws(resampler, dt):
    """Each resampler fed JAX's uniform(s) from the same key: the gathered
    walker (its index, column 0) agrees wherever the comb point is no
    near-tie of a CDF step (cumsum and the sum in ``_sanitize`` add in other
    orders)."""
    n = 5000
    w = _dmc_weights(11, n, dt)
    walkers = np.stack([np.arange(n), np.arange(n) * 0.5], axis=1).astype(np.float32)
    key = jax.random.PRNGKey(12)
    j_out = np.asarray(jres.RESAMPLERS[resampler](key, jnp.asarray(walkers), jnp.asarray(w)))
    shape = (n,) if resampler == "multinomial" else ()
    u = np.array(jax.random.uniform(key, shape, dtype=jnp.float32))
    t_out = resampling.RESAMPLERS_FROM[resampler](torch.from_numpy(walkers), torch.from_numpy(w),
                                                  torch.from_numpy(u)).numpy()
    points = u if resampler == "multinomial" else (np.arange(n, dtype=np.float32) + u) / np.float32(n)
    tie = _near_ties(w, points)
    same = np.all(t_out == j_out, axis=1)
    assert np.all(same | tie), (int((~same).sum()), int(tie.sum()))
    assert tie.mean() < 0.02
    if dt > 0.1:
        assert len(np.unique(j_out[:, 0])) < n  # the weights branched


@pytest.mark.parametrize("resampler", ["multinomial", "systematic"])
def test_resampler_concentrated_and_nan_weights(resampler):
    gen = make_generator(6, "cpu")
    walkers = torch.arange(100, dtype=torch.float32).reshape(100, 1)
    w = torch.zeros(100)
    w[42] = 1.0
    out = resampling.RESAMPLERS[resampler](gen, walkers, w)
    assert torch.equal(out, torch.full((100, 1), 42.0))
    out = resampling.RESAMPLERS[resampler](gen, torch.randn((64, 1), generator=gen), torch.full((64,), float("nan")))
    assert bool(torch.isfinite(out).all())


def test_sanitize_matches_jax():
    rng = np.random.default_rng(3)
    cases = [
        rng.uniform(0, 2, 32).astype(np.float32),
        np.array([1.0, np.nan, 2.0, np.inf, -np.inf, 0.5, -1.0, 3.0], np.float32),
        np.full(8, np.nan, np.float32),
        np.zeros(8, np.float32),
        np.array([-1.0, -2.0, np.inf], np.float32),
    ]
    for w in cases:
        got = resampling._sanitize(torch.from_numpy(w)).numpy()
        want = np.asarray(jres._sanitize(jnp.asarray(w)))
        _close(got, want)
        for fallback in (True, False):
            _close(debug.sanitize_weights(torch.from_numpy(w), fallback).numpy(),
                   np.asarray(jdebug.sanitize_weights(jnp.asarray(w), fallback)))


# -- Adam ------------------------------------------------------------------------


def _grads(seed: int, n: int, keys=None):
    """A gradient sequence whose size falls from ~1 to noise, as VMC's does."""
    rng = np.random.default_rng(seed)
    scale = np.logspace(0, -3, n)[:, None]
    g = (rng.normal(size=(n, len(keys or [0]))) * scale).astype(np.float32)
    return [dict(zip(keys, row)) if keys else row[0] for row in g]


def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} if isinstance(tree, dict) else jnp.asarray(tree)


@pytest.mark.parametrize("keys", [None, ["alpha", "beta"]])
def test_adam_one_update_from_init_bit_equal(keys):
    """The first update of ``jax.jit(optax.adam(lr).update)`` (how JAX's
    VMC runs it), bit for bit."""
    params = {k: np.float32(v) for k, v in ANH_PARAMS.items()} if keys else np.float32(1.0)
    opt = optax.adam(0.02)
    for g in _grads(0, 8, keys):
        u_j, s_j = jax.jit(opt.update)(_to_jax(g), opt.init(_to_jax(params)))
        u_t, s_t = adam.adam_update(mc_params_from_jax(g, "cpu"), adam.adam_init(mc_params_from_jax(params, "cpu")),
                                    0.02)
        for leaf_j, leaf_t in zip(jax.tree.leaves(u_j), adam.tree_leaves(u_t)):
            assert np.float32(leaf_j) == leaf_t.numpy()
        assert int(s_t.count) == int(s_j[0].count) == 1 and s_t.count.dtype == torch.int32


@pytest.mark.parametrize("keys", [None, ["alpha", "beta"]])
def test_adam_50_updates_match_optax(keys):
    """50 updates: the state of optax's after every one carried into the
    port (``adam_state_from_jax``) gives the next update within 1e-6 x lr
    (XLA's FMA in the moments, its float32 ``pow``); the parameters run
    apart by at most rtol 1e-6 over all 50."""
    lr = 0.02
    params = {k: np.float32(v) for k, v in ANH_PARAMS.items()} if keys else np.float32(1.0)
    opt = optax.adam(lr)
    upd, apply = jax.jit(opt.update), jax.jit(optax.apply_updates)
    p_j = _to_jax(params)
    s_j = opt.init(p_j)
    p_t = mc_params_from_jax(params, "cpu")
    s_t = adam.adam_init(p_t)
    for g in _grads(1, 50, keys):
        st = s_j[0]
        carried = adam_state_from_jax(np.asarray(st.count), jax.tree.map(np.asarray, st.mu),
                                      jax.tree.map(np.asarray, st.nu), "cpu")
        u_j, s_j = upd(_to_jax(g), s_j)
        p_j = apply(p_j, u_j)
        u_c, _ = adam.adam_update(mc_params_from_jax(g, "cpu"), carried, lr)
        u_t, s_t = adam.adam_update(mc_params_from_jax(g, "cpu"), s_t, lr)
        p_t = adam.apply_updates(p_t, u_t)
        for a, b in zip(adam.tree_leaves(u_c), jax.tree.leaves(u_j)):
            _close(a.numpy(), b, atol_scale=lr)
    assert int(s_t.count) == 50
    for a, b in zip(adam.tree_leaves(p_t), jax.tree.leaves(p_j)):
        _close(a.numpy(), b)


# -- the VMC epoch and the DMC step -----------------------------------------------


@pytest.mark.parametrize("kind", ["harmonic", "anharmonic"])
def test_epoch_gradient_and_update_for_given_walkers(kind):
    """JAX's ``epoch_step`` at ``n_equil`` 0 (the walkers stay as given):
    the energy mean, the REINFORCE gradient (the ``tensordot`` over walkers:
    to 1e-6 of 2 sum |(E_L - <E_L>) g| / n) and the clamped Adam step."""
    dim, n = 3, 2000
    jm, tm, jp, tp = _models(kind, dim)
    x = _walkers(9, n, dim, 0.9)
    jc = jax_override(JaxVMCDMCConfig(), n_equil=0, dim=dim)
    tc = override(VMCDMCConfig(), n_equil=0, dim=dim)
    opt = optax.adam(jc.lr)
    carry = (jnp.asarray(x), jp, jax.random.PRNGKey(0), opt.init(jp))
    (_, jp1, _, _), (je, _, jg, ja) = jax.jit(jvmc.make_epoch_step(jm, jc, opt))(carry, None)
    (tw1, tp1, _), (te, _, tg, ta) = vmc.make_epoch_step(tm, tc)(
        torch.from_numpy(x), tp, make_generator(0, "cpu"), adam.adam_init(tp))
    assert torch.equal(tw1, torch.from_numpy(x)) and float(ta) == float(ja) == 0.0
    _close(float(te), float(je))
    energies = tm.local_energy(tp, torch.from_numpy(x))
    per_walker = torch.func.vmap(torch.func.grad(tm.log_psi), in_dims=(None, 0))(tp, torch.from_numpy(x))
    centered = (energies - energies.mean()).abs()
    for k, (a, b) in enumerate(zip(adam.tree_leaves(tg), jax.tree.leaves(jg))):
        scale = 2.0 * float(torch.sum(centered * adam.tree_leaves(per_walker)[k].abs())) / n
        _close(float(a), float(b), atol_scale=scale)
    for a, b in zip(adam.tree_leaves(tp1), jax.tree.leaves(jp1)):
        _close(float(a), float(b))


def test_clamp_applies_to_every_leaf():
    """The ``alpha_min`` clamp after the Adam step reaches ``beta`` too, as
    JAX's ``jax.tree.map`` does (mc/vmc.py:70)."""
    m = models.AnharmonicOscillator(dim=1)
    cfg = override(VMCDMCConfig(), n_equil=0, dim=1, lr=0.5, alpha_min=0.2)
    params = {"alpha": torch.tensor(0.6), "beta": torch.tensor(0.05)}
    (_, p1, _), _ = vmc.make_epoch_step(m, cfg)(torch.from_numpy(_walkers(0, 500, 1)), params,
                                               make_generator(0, "cpu"), adam.adam_init(params))
    assert float(p1["beta"]) >= 0.2 and float(p1["alpha"]) >= 0.2


@pytest.mark.parametrize("kind", ["harmonic", "anharmonic"])
@pytest.mark.parametrize("resampler", ["multinomial", "systematic"])
def test_dmc_step_with_jax_draws(kind, resampler):
    """One DMC step at JAX's draws (``split(key, 3)``: the resampler's
    uniform(s), then the normals): E_ref at rtol 1e-6, and every walker
    whose comb point is no near-tie at rtol 1e-6 (the move's FMA)."""
    dim, n, dt = 3, 3000, 0.01
    jm, tm, jp, tp = _models(kind, dim)
    x = _walkers(4, n, dim, 1.1)
    key = jax.random.PRNGKey(21)
    (j_new, _), j_eref = jdmc.make_dmc_step(jm, jp, dt, resampler)((jnp.asarray(x), key), None)
    _, k_res, k_dif = jax.random.split(key, 3)
    u = np.array(jax.random.uniform(k_res, (n,) if resampler == "multinomial" else (), dtype=jnp.float32))
    noise = np.array(jax.random.normal(k_dif, (n, dim), dtype=jnp.float32))
    t_new, t_eref = dmc.make_dmc_update(tm, tp, dt, resampler)(torch.from_numpy(x), torch.from_numpy(u),
                                                               torch.from_numpy(noise))
    _close(float(t_eref), float(j_eref))
    e = np.asarray(jm.local_energy(jp, jnp.asarray(x)))
    weights = np.exp(-(e - np.float32(j_eref)) * np.float32(dt)).astype(np.float32)
    points = u if resampler == "multinomial" else (np.arange(n, dtype=np.float32) + u) / np.float32(n)
    keep = ~_near_ties(weights, points)
    _close(t_new.numpy()[keep], np.asarray(j_new)[keep])
    assert keep.mean() > 0.98  # a comb point near a CDF step: ~2e-6 n of them


# -- whole runs ------------------------------------------------------------------


def test_vmc_converges_to_exact_alpha():
    """JAX's test_mc configuration and bounds."""
    cfg = override(VMCDMCConfig(), n_walkers=2000, n_epochs=300, n_equil=20, dim=3, epoch_chunk=100)
    res = run_vmc(HarmonicOscillator(dim=3), cfg, device="cpu")
    assert abs(float(res.params) - 0.5) < 0.05, float(res.params)
    assert abs(float(res.energy_history[-1]) - 1.5) < 0.05
    assert res.energy_history.shape == (300,) and res.params_history.shape == (300,)
    assert res.grad_history.shape == (300,) and res.accept_history.shape == (300,)
    assert bool(((res.accept_history > 0.1) & (res.accept_history < 0.9)).all())


def test_vmc_same_seed_same_history_other_seed_other():
    cfg = override(VMCDMCConfig(), n_walkers=256, n_epochs=5, n_equil=5, epoch_chunk=5)
    m = HarmonicOscillator(dim=2)
    a = run_vmc(m, override(cfg, seed=1), device="cpu")
    b = run_vmc(m, override(cfg, seed=1), device="cpu")
    c = run_vmc(m, override(cfg, seed=2), device="cpu")
    assert torch.equal(a.energy_history, b.energy_history) and torch.equal(a.walkers, b.walkers)
    assert not torch.allclose(a.energy_history, c.energy_history)


def test_vmc_zero_epochs_probe_keeps_the_start():
    """No epoch to run: one probe epoch fills the histories and its carry
    is dropped (JAX's ``run_vmc`` when every epoch is already done)."""
    cfg = override(VMCDMCConfig(), n_walkers=64, n_epochs=0, n_equil=2, dim=2)
    res = run_vmc(HarmonicOscillator(dim=2), cfg, device="cpu")
    assert res.energy_history.shape == (1,) and res.params_history.shape == (1,)
    assert float(res.params) == cfg.alpha_init and float(res.params_history[0]) != cfg.alpha_init
    walkers = torch.randn((64, 2), generator=make_generator(cfg.seed, "cpu"))
    assert torch.equal(res.walkers, walkers)


@pytest.mark.parametrize("resampler", ["systematic", "multinomial"])
def test_dmc_ground_state_energy(resampler):
    """JAX's test_mc configuration and bound: E_0 = D/2."""
    cfg = override(VMCDMCConfig(), n_walkers=4000, n_dmc=400, dmc_dt=0.01, dim=3, resampler=resampler)
    gen = make_generator(11, "cpu")
    walkers = torch.randn((cfg.n_walkers, 3), generator=gen)
    res = run_dmc(HarmonicOscillator(dim=3), torch.tensor(0.45), walkers, make_generator(12, "cpu"), cfg)
    mean, err = res.mean_energy(burn_in=100)
    assert abs(float(mean) - 1.5) < 0.05, (resampler, float(mean))
    assert 0 < float(err) < 0.05 and res.energy_history.shape == (400,)
    assert res.walker_snapshots is None


@pytest.mark.parametrize("snapshot_every, n_snaps", [(10, 5), (15, 3), (60, None)])
def test_dmc_snapshot_shapes(snapshot_every, n_snaps):
    """Snapshots every ``snapshot_every`` steps, the remainder after the last
    (50 = 3 x 15 + 5), none when ``snapshot_every > n_dmc``; the shapes
    JAX's ``_make_program`` gives."""
    cfg = override(VMCDMCConfig(), n_walkers=128, n_dmc=50, dim=2, snapshot_every=snapshot_every)
    w = torch.randn((128, 2), generator=make_generator(13, "cpu"))
    res = run_dmc(HarmonicOscillator(dim=2), torch.tensor(0.5), w, make_generator(14, "cpu"), cfg)
    assert res.energy_history.shape == (50,)
    jres_ = jdmc.run_dmc(jmodels.HarmonicOscillator(dim=2), jnp.asarray(0.5), jnp.asarray(w.numpy()),
                         jax.random.PRNGKey(14), jax_override(JaxVMCDMCConfig(), **{
                             k: getattr(cfg, k) for k in ("n_walkers", "n_dmc", "dim", "snapshot_every")}))
    if n_snaps is None:
        assert res.walker_snapshots is None and jres_.walker_snapshots is None
    else:
        assert res.walker_snapshots.shape == jres_.walker_snapshots.shape == (n_snaps, 128, 2)


def test_vmc_snapshots_gcd_chunks_and_progress():
    """With ``snapshot_every`` 4 and ``epoch_chunk`` 6 the chunk is gcd = 2:
    a snapshot at every multiple of 4 and at the end; ``progress_cb`` once a
    chunk."""
    cfg = override(VMCDMCConfig(), n_walkers=64, n_epochs=10, n_equil=2, epoch_chunk=6, snapshot_every=4, dim=2)
    calls = []
    res = run_vmc(HarmonicOscillator(dim=2), cfg, progress_cb=lambda e, en, a: calls.append((e, en, a)),
                  device="cpu")
    assert [c[0] for c in calls] == [2, 4, 6, 8, 10]
    assert calls[-1][1] == float(res.energy_history[-1]) and calls[-1][2] == float(res.params)
    assert res.walker_snapshots.shape == (3, 64, 2)
    assert torch.equal(res.walker_snapshots[-1], res.walkers)


def test_mean_energy_equal_to_jax():
    """``mean_energy`` on one history array in both packages (the mean and
    the population std: rtol 1e-6, their sums)."""
    hist = (1.5 + 0.01 * np.random.default_rng(2).normal(size=400)).astype(np.float32)
    j = jdmc.DMCResult(walkers=None, energy_history=jnp.asarray(hist), walker_snapshots=None)
    t = dmc.DMCResult(walkers=None, energy_history=torch.from_numpy(hist), walker_snapshots=None)
    for burn_in in (0, 100, 399):
        (jm_, je), (tm_, te) = j.mean_energy(burn_in), t.mean_energy(burn_in)
        _close(float(tm_), float(jm_))
        _close(float(te), float(je))
    assert np.isnan(float(t.mean_energy(400)[0])) and np.isnan(float(j.mean_energy(400)[0]))


def test_anharmonic_vmc_dmc_oracle():
    """JAX's test_mc configuration and bounds against the 1D
    diagonalization oracle (dim 1, lam 0.2)."""
    cfg = override(VMCDMCConfig(), potential="anharmonic", lam=0.2, dim=1, n_walkers=1000, n_epochs=200,
                   n_equil=10, epoch_chunk=50, lr=0.05, n_dmc=150, prng_impl="threefry")
    res = quantum_oscillator.run(cfg, device="cpu")
    assert res.exact_alpha is None
    assert abs(res.vmc_energy - res.exact_energy) < 2e-2
    mean, _ = res.dmc.mean_energy()
    assert abs(float(mean) - res.exact_energy) < 1e-2
    assert float(res.vmc.params["beta"]) != 0.05
    assert res.vmc_alpha == float(res.vmc.params["alpha"])
    assert set(res.vmc.params_history) == {"alpha", "beta"} and res.vmc.params_history["beta"].shape == (200,)


def test_quantum_workload_dim2():
    """``quantum_oscillator.run`` at dim 2 (JAX's test_mc configuration and
    bounds)."""
    cfg = override(VMCDMCConfig(), n_walkers=1000, n_epochs=150, n_equil=10, n_dmc=150, dim=2, epoch_chunk=50)
    res = quantum_oscillator.run(cfg, device="cpu")
    assert abs(res.vmc_alpha - 0.5) < 0.1
    mean, _ = res.dmc.mean_energy(burn_in=50)
    assert abs(float(mean) - 1.0) < 0.1
    assert res.exact_energy == 1.0 and res.exact_alpha == 0.5
    assert res.vmc_wall_s > 0 and res.dmc_wall_s > 0
    with pytest.raises(ValueError, match="unknown potential"):
        quantum_oscillator.make_model(override(cfg, potential="morse"))


def test_generator_streams():
    a, b = make_generator(5, "cpu"), make_generator(5, "cpu")
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=make_generator(6, "cpu")), torch.rand(4, generator=a))


# -- utils/debug -----------------------------------------------------------------


def test_debug_all_and_assert_finite_match_jax():
    good = {"b": np.ones(3, np.float32), "a": np.zeros((2, 2), np.float32), "i": np.arange(3)}
    bad = dict(good, a=np.array([[0.0, np.nan], [1.0, 2.0]], np.float32))
    worse = dict(bad, b=np.array([1.0, np.inf, 0.0], np.float32))
    for tree in (good, bad, worse):
        t_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
        j_tree = {k: jnp.asarray(v) for k, v in tree.items()}
        assert bool(debug.all_finite(t_tree)) == bool(jdebug.all_finite(j_tree))
        msgs = []
        for fn, tr in ((jdebug.assert_finite, j_tree), (debug.assert_finite, t_tree)):
            try:
                fn(tr, "walkers")
                msgs.append(None)
            except FloatingPointError as exc:
                msgs.append(str(exc))
        assert msgs[0] == msgs[1], msgs
    assert bool(debug.all_finite({"i": torch.arange(3)})) and bool(debug.all_finite([]))
    pos = np.array([[0.0, 1.0], [np.nan, 0.0]], np.float32)
    vel = np.zeros((2, 2), np.float32)
    js = JaxParticleState.create(jnp.asarray(pos), jnp.asarray(vel))
    ts = ParticleState.create(torch.from_numpy(pos), torch.from_numpy(vel))
    with pytest.raises(FloatingPointError) as j_exc:
        jdebug.assert_finite(js)
    with pytest.raises(FloatingPointError) as t_exc:
        debug.assert_finite(ts)
    assert str(t_exc.value) == str(j_exc.value) == "non-finite values in state.position"
    assert not bool(debug.all_finite(ts)) and bool(debug.all_finite(ts.replace(position=torch.zeros(2, 2))))


# -- the CLI ---------------------------------------------------------------------


def test_cli_vmc_cpu(capsys):
    """JAX's tests/test_cli.py sizes (burn-in 100 exceeds 20 DMC steps: the
    DMC mean is NaN in both packages)."""
    argv = ["vmc", "--n_walkers", "200", "--n_epochs", "20", "--n_equil", "5", "--n_dmc", "20", "--dim", "2",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "VMC epoch 20" in out
    assert "VMC  : E = " in out and "(exact 1.000000), alpha = " in out and "(exact 0.5)" in out
    assert "DMC  : E = " in out


def test_cli_vmc_anharmonic_cpu(capsys):
    argv = ["vmc", "--n_walkers", "200", "--n_epochs", "10", "--n_equil", "3", "--n_dmc", "120", "--dim", "1",
            "--potential", "anharmonic", "--resampler", "multinomial", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "(no closed form)" in out and "potential=anharmonic (lam=0.2)" in out


def test_cli_vmc_without_card_exits_2(capsys):
    """``--device cuda`` (the default) without a card: exit 2, as ``md``."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    assert cli.main(["vmc", "--n_epochs", "1"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
