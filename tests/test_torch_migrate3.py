"""The 3D rebuild of the PyTorch port against the JAX package: the
allocation (``GridMD3._migration_dest``) integer-exact, the plain version
of kernels B6/B7 bit-exact against ``migrate_pallas3.make_migrate_kernel3``
in interpret mode, the whole rebuild against the JAX package's own
row-permutation rebuild, B6 against B7, and the mover flag ``mov_of`` in
both packages (the port's engine counts it in ``mover_flags``)."""

import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn as jax_make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3 as JaxGridMD3
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.migrate_pallas3 import (
    make_migrate_kernel3 as jax_make_migrate_kernel3,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid3_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda3
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
from tests.torch_parity import (
    GRID3_STATE_FIELDS,
    exact_pallas_reciprocal,
    jax_grid_arrays,
    lattice_positions,
    velocities,
)

N, BOX, K_MOV = 1000, 12.0, 8  # rho 0.58: cps 4, cap 32
GRID3_FIELDS = ("xg", "yg", "zg", "vxg", "vyg", "vzg", "fxg", "fyg", "fzg", "occ", "pid",
                "crx", "cry", "crz", "cvx", "cvy", "cvz")
# three of the rebuild's fields, one for each kind of fill
FIELDS = ("xg", "vzg", "pid")


def _moved(gs, step: float, seed: int):
    """``gs`` with every particle displaced by up to ``step`` on each axis,
    as windows would move it (at most one cell), unwrapped."""
    rng = np.random.default_rng(seed)
    occ = np.asarray(gs.occ)
    moves = {}
    for name in ("xg", "yg", "zg"):
        d = rng.uniform(-step, step, occ.shape).astype(np.float32) * occ
        moves[name] = gs.__getattribute__(name) + jnp.asarray(d)
    return gs.replace(**moves)


@pytest.fixture(scope="module")
def states():
    """A Kahan state in JAX, moved mildly (no cell with more than K_MOV
    movers) and hot (some cell with more), the same states carried into the
    port, and the JAX allocation of each."""
    pos = np.mod(lattice_positions(N, BOX, seed=6, dim=3), BOX)
    vel = velocities(N, kt=1.0, seed=7, dim=3)
    gf_j = jax_make_cell_grid_fn(BOX, 2.5, N, dim=3)
    md_j = JaxGridMD3(gf_j, compensated=True, static_cov="auto", migrate_k_mov=K_MOV)
    md_t = GridMD3(make_cell_grid_fn(BOX, 2.5, N, dim=3), compensated=True, static_cov="auto",
                   migrate_k_mov=K_MOV, device="cpu")
    with exact_pallas_reciprocal():
        gs0 = md_j.init(jnp.asarray(pos), jnp.asarray(vel))
    dest = jax.jit(md_j._migration_dest3)
    out = {}
    for name, step in (("mild", 0.35), ("hot", 1.2)):
        gs = _moved(gs0, step, seed=len(name))
        out[name] = (gs, grid3_state_from_jax(jax_grid_arrays(gs, GRID3_STATE_FIELDS), md_t), dest(gs))
    return md_j, md_t, out


def _movers_per_cell(scode: np.ndarray, cap: int) -> np.ndarray:
    return ((scode >= 0) & (scode // cap != migrate_cuda3.STAY)).sum(1)


@pytest.mark.parametrize("which", ["mild", "hot"])
def test_migration_dest_matches_jax(states, which):
    md_j, md_t, out = states
    gs_j, gs_t, dest_j = out[which]
    live, cap = md_t.plane, md_t.cap
    xw_j, yw_j, zw_j, scode_j, occ_j, _, ovf_j = dest_j
    xw_t, yw_t, zw_t, scode_t, occ_t, ovf_t, _ = md_t._migration_dest(gs_t)
    scode_j = np.asarray(scode_j)[:, :, :live]
    assert scode_t.dtype == torch.int32
    np.testing.assert_array_equal(scode_t.numpy(), scode_j)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j)[:, :, :live])
    for a, b in ((xw_t, xw_j), (yw_t, yw_j), (zw_t, zw_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:, :, :live])
    assert bool(ovf_t) == bool(ovf_j) is False
    assert int(occ_t.sum()) == N
    movers = _movers_per_cell(scode_j, cap)
    assert movers.sum() > 100  # many particles change cell, in many directions
    assert len(np.unique(scode_j[scode_j >= 0] // cap)) >= 15
    assert (movers.max() > K_MOV) == (which == "hot")


def test_migrate_plain_matches_jax_kernel(states):
    """B6's plain version against JAX's B6 (compacted, k_mov 8) on the mild
    state: bit-equal on every live slot."""
    md_j, md_t, out = states
    gs_j, gs_t, dest_j = out["mild"]
    live, cap = md_t.plane, md_t.cap
    scode_j, occ_j = dest_j[3], dest_j[4]
    fills = [md_t.sentinel, 0.0, -1.0]
    kernel = jax_make_migrate_kernel3(md_t.cps, cap, len(FIELDS), fills, interpret=True, k_mov=K_MOV)
    new_mo = jnp.max(jnp.sum(occ_j, axis=1)).astype(jnp.int32)
    out_j, of_j = kernel(gs_j.max_occ, new_mo, scode_j, *(getattr(gs_j, k).astype(jnp.float32) for k in FIELDS))
    scode_t = torch.from_numpy(np.ascontiguousarray(np.asarray(scode_j)[:, :, :live]))
    occ_t = torch.from_numpy(np.ascontiguousarray(np.asarray(occ_j, np.float32)[:, :, :live]))
    fields_t = torch.stack([getattr(gs_t, k).to(torch.float32) for k in FIELDS])
    before = (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES)
    out_t, of_t = migrate_cuda3.migrate3(scode_t, fields_t, fills, k_mov=K_MOV, occ=occ_t)
    assert (migrate_cuda3.LAUNCHES, migrate_cuda3.FLAT_LAUNCHES) == before  # CPU: the plain version
    assert bool(of_t) == bool(of_j) is False
    for f, name in enumerate(FIELDS):
        np.testing.assert_array_equal(out_t[f].numpy(), np.asarray(out_j[f])[:, :, :live], err_msg=name)


def test_rebuild_matches_jax(states):
    """The port's whole rebuild (allocation + B6's plain version, 16
    fields) against the JAX package's row-permutation rebuild of the same
    allocation (``_rebuild_migrate_rows``, plain jnp): bit-equal grids, the
    same max occupancy and flags, coordinates wrapped into [0, box)."""
    md_j, md_t, out = states
    gs_j, gs_t, _ = out["mild"]
    live = md_t.plane
    rb_j = jax.jit(md_j._rebuild_migrate_rows)(gs_j)
    rb_t = md_t._rebuild_migrate(gs_t)
    for name in GRID3_FIELDS:
        np.testing.assert_array_equal(
            getattr(rb_t, name).numpy(), np.asarray(getattr(rb_j, name))[:, :, :live], err_msg=name
        )
    assert int(rb_t.max_occ) == int(rb_j.max_occ)
    assert bool(rb_t.overflow) == bool(rb_j.overflow) is False
    assert int(rb_t.mover_flags) == 0
    assert float(rb_t.dmax2) == 0.0 and float(rb_t.dispz.abs().max()) == 0.0
    occ = rb_t.occ > 0.5
    for g in (rb_t.xg, rb_t.yg, rb_t.zg):
        assert bool(((g[occ] >= 0) & (g[occ] < md_t.box)).all())


def test_compact_equals_flat(states):
    """B6 and B7 are one permutation: the engine's rebuild with
    ``migrate_compact=False`` gives the same grids, and B7 never raises
    ``mov_of``, even where B6 does. B6's flag adds to ``mover_flags`` and
    raises no ``overflow``: nothing is lost."""
    _, md_t, out = states
    md_flat = GridMD3(md_t.grid_fn, compensated=True, static_cov="auto", migrate_compact=False, device="cpu")
    for which in ("mild", "hot"):
        gs_t = out[which][1]
        rb_c, rb_f = md_t._rebuild_migrate(gs_t), md_flat._rebuild_migrate(gs_t)
        for name in GRID3_FIELDS:
            assert torch.equal(getattr(rb_c, name), getattr(rb_f, name)), (which, name)
        assert not bool(rb_f.overflow) and not bool(rb_c.overflow)
        assert int(rb_f.mover_flags) == 0
        assert int(rb_c.mover_flags) == int(which == "hot")
        _, _, _, scode, occ_new, _, _ = md_t._migration_dest(gs_t)
        fields = torch.stack([gs_t.xg, gs_t.pid.float()])
        a, of_c = migrate_cuda3.migrate3(scode, fields, [md_t.sentinel, -1.0], k_mov=K_MOV, occ=occ_new)
        b, of_f = migrate_cuda3.migrate3(scode, fields, [md_t.sentinel, -1.0], occ=occ_new)
        assert torch.equal(a, b) and not bool(of_f)
        assert bool(of_c) == (which == "hot")


def test_mover_overflow_raised_in_both(states):
    """On the hot state some cell has more than k_mov movers: JAX's B6 drops
    them and raises its flag; the port raises the same flag from the same
    codes (and drops nothing: its output is the JAX flat kernel B7's), so
    the engine counts the rebuild in ``mover_flags`` and leaves ``overflow``
    down."""
    md_j, md_t, out = states
    gs_j, gs_t, dest_j = out["hot"]
    live, cap = md_t.plane, md_t.cap
    scode_j, occ_j = dest_j[3], dest_j[4]
    field = gs_j.vzg.astype(jnp.float32)
    _, of_j = jax_make_migrate_kernel3(md_t.cps, cap, 1, [0.0], interpret=True, k_mov=K_MOV)(cap, cap, scode_j, field)
    flat_j, of_flat_j = jax_make_migrate_kernel3(md_t.cps, cap, 1, [0.0], interpret=True, compact=False)(
        cap, cap, scode_j, field
    )
    assert bool(of_j) and not bool(of_flat_j)
    scode_t = torch.from_numpy(np.ascontiguousarray(np.asarray(scode_j)[:, :, :live]))
    occ_t = torch.from_numpy(np.ascontiguousarray(np.asarray(occ_j, np.float32)[:, :, :live]))
    out_t, of_t = migrate_cuda3.migrate3(scode_t, [gs_t.vzg.contiguous()], [0.0], k_mov=K_MOV, occ=occ_t)
    assert bool(of_t) and bool(migrate_cuda3.mover_overflow(scode_t, K_MOV))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(flat_j[0])[:, :, :live])
    rb = md_t._rebuild_migrate(gs_t)
    assert int(rb.mover_flags) == 1 and not bool(rb.overflow)


def test_migrate_reference_is_the_permutation():
    """The plain version against a slot-by-slot loop on random injective
    codes over all 27 directions (several movers into one target cell and
    wraps on every axis included)."""
    cps, cap, n_fields = 3, 4, 2
    rng = np.random.default_rng(0)
    scode = np.full((cps, cap, cps * cps), -1, np.int32)
    taken = set()

    def target(cx, cy, cz, d):
        return (cx + d // 9 - 1) % cps, (cy + (d // 3) % 3 - 1) % cps, (cz + d % 3 - 1) % cps

    for cx in range(cps):
        for b in range(cap):
            for lane in range(cps * cps):
                if rng.random() < 0.3:
                    continue
                d = int(rng.integers(27))
                t = target(cx, lane // cps, lane % cps, d)
                free = [a for a in range(cap) if (t, a) not in taken]
                if free:
                    taken.add((t, free[0]))
                    scode[cx, b, lane] = d * cap + free[0]
    fields = rng.standard_normal((n_fields, cps, cap, cps * cps)).astype(np.float32)
    fills = [7.0, -1.0]
    want = np.empty_like(fields)
    want[0], want[1] = fills
    for cx in range(cps):
        for b in range(cap):
            for lane in range(cps * cps):
                code = scode[cx, b, lane]
                if code >= 0:
                    d, a = divmod(int(code), cap)
                    tx, ty, tz = target(cx, lane // cps, lane % cps, d)
                    want[:, tx, a, ty * cps + tz] = fields[:, cx, b, lane]
    got = migrate_cuda3.migrate3_reference(torch.from_numpy(scode), torch.from_numpy(fields), fills)
    np.testing.assert_array_equal(got.numpy(), want)


def test_migrate_wrapper_rejects_bad_inputs():
    scode = torch.full((3, 4, 9), -1, dtype=torch.int32)
    fields = torch.zeros((2, 3, 4, 9))
    occ = torch.zeros((3, 4, 9))
    with pytest.raises(TypeError):
        migrate_cuda3.migrate3(scode.long(), fields, [0.0, 0.0], occ=occ)
    with pytest.raises(TypeError):
        migrate_cuda3.migrate3(scode, fields.double(), [0.0, 0.0], occ=occ)
    with pytest.raises(ValueError, match="grid"):
        migrate_cuda3.migrate3(scode[:, :2], fields, [0.0, 0.0], occ=occ)
    with pytest.raises(ValueError, match="grid"):
        migrate_cuda3.migrate3(torch.full((3, 4, 8), -1, dtype=torch.int32), torch.zeros((2, 3, 4, 8)), [0.0, 0.0],
                               occ=occ)
    with pytest.raises(ValueError, match="fills"):
        migrate_cuda3.migrate3(scode, fields, [0.0], occ=occ)
    with pytest.raises(ValueError, match="contiguous"):
        migrate_cuda3.migrate3(scode, fields.transpose(2, 3).contiguous().transpose(2, 3), [0.0, 0.0], occ=occ)
    with pytest.raises(ValueError, match="k_mov"):
        migrate_cuda3.migrate3(scode, fields, [0.0, 0.0], k_mov=0, occ=occ)
    with pytest.raises(ValueError):
        migrate_cuda3.migrate3(scode.to("meta"), fields.to("meta"), [0.0, 0.0], occ=occ.to("meta"))
