"""The rebuild of the PyTorch port against the JAX package: the allocation
(``GridMD._migration_dest``) integer-exact, kernel B2's plain version
bit-exact against ``migrate_pallas.make_migrate_kernel`` in interpret mode,
and the whole rebuild, on a state advanced past a rebuild."""

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
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD as JaxGridMD
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.migrate_pallas import (
    make_migrate_kernel as jax_make_migrate_kernel,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.interop import grid_state_from_jax
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels import migrate_cuda
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md import GridMD
from tests.torch_parity import (
    exact_pallas_reciprocal,
    jax_grid_arrays,
    lattice_positions,
    velocities,
)

N, RHO = 512, 0.8  # cps 8, cap 24
GRID_FIELDS = ("xg", "yg", "vxg", "vyg", "fxg", "fyg", "occ", "pid", "crx", "cry", "cvx", "cvy")


@pytest.fixture(scope="module")
def advanced():
    """A Kahan state advanced window -> rebuild -> window in JAX, and the
    same state carried into the port."""
    box = float(np.sqrt(N / RHO))
    pos = np.mod(lattice_positions(N, box, seed=6), box)
    vel = velocities(N, kt=1.0, seed=7)
    gf_j = jax_make_cell_grid_fn(box, 2.5, N, dim=2)
    md_j = JaxGridMD(gf_j, dt=2e-3, compensated=True, rows_per_block=1)
    md_t = GridMD(make_cell_grid_fn(box, 2.5, N, dim=2), dt=2e-3, compensated=True, rows_per_block=1,
                  device="cpu")
    rebuild = jax.jit(md_j._rebuild_migrate)
    with exact_pallas_reciprocal():
        window = jax.jit(md_j._make_window(md_j.force_kernel, 20))
        gs = window(md_j.init(jnp.asarray(pos), jnp.asarray(vel)))
        gs = window(rebuild(gs))
    dest = jax.jit(md_j._migration_dest)(gs)
    return md_j, md_t, gs, grid_state_from_jax(jax_grid_arrays(gs), md_t), dest, rebuild(gs)


def test_migration_dest_matches_jax(advanced):
    md_j, md_t, gs_j, gs_t, dest_j, _ = advanced
    cps, cap = md_t.cps, md_t.cap
    xw_j, yw_j, scode_j, occ_j, _, ovf_j = dest_j
    xw_t, yw_t, scode_t, occ_t, ovf_t, _ = md_t._migration_dest(gs_t)
    scode_j = np.asarray(scode_j)[:, :, :cps]
    assert scode_t.dtype == torch.int32
    np.testing.assert_array_equal(scode_t.numpy(), scode_j)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j)[:, :, :cps])
    assert bool(ovf_t) == bool(ovf_j) is False
    np.testing.assert_array_equal(xw_t.numpy(), np.asarray(xw_j)[:, :, :cps])
    np.testing.assert_array_equal(yw_t.numpy(), np.asarray(yw_j)[:, :, :cps])
    # the state is past a rebuild and some particles change cell
    dcode = scode_j[scode_j >= 0] // cap
    assert (dcode != 4).sum() > 0
    assert int(occ_t.sum()) == N


def test_migrate_plain_matches_jax_kernel(advanced):
    md_j, md_t, gs_j, gs_t, dest_j, _ = advanced
    cps, cap = md_t.cps, md_t.cap
    scode_j = dest_j[2]
    fills = [md_t.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0]
    names = ("xg", "yg", "vxg", "vyg", "fxg", "fyg", "pid", "crx", "cry", "cvx", "cvy")
    fields_j = [getattr(gs_j, k).astype(jnp.float32) for k in names]
    out_j = jax_make_migrate_kernel(cps, cap, 1, len(names), fills, interpret=True)(scode_j, *fields_j)
    scode_t = torch.from_numpy(np.ascontiguousarray(np.asarray(scode_j)[:, :, :cps]))
    fields_t = torch.stack([getattr(gs_t, k).to(torch.float32) for k in names])
    before = migrate_cuda.LAUNCHES
    out_t = migrate_cuda.migrate(scode_t, fields_t, fills)
    assert migrate_cuda.LAUNCHES == before  # CPU tensors take the plain version
    for f in range(len(names)):
        np.testing.assert_array_equal(out_t[f].numpy(), np.asarray(out_j[f])[:, :, :cps], err_msg=names[f])


def test_rebuild_matches_jax(advanced):
    md_j, md_t, gs_j, gs_t, _, rb_j = advanced
    cps = md_t.cps
    rb_t = md_t._rebuild_migrate(gs_t)
    for name in GRID_FIELDS:
        np.testing.assert_array_equal(
            getattr(rb_t, name).numpy(), np.asarray(getattr(rb_j, name))[:, :, :cps], err_msg=name
        )
    assert bool(rb_t.overflow) == bool(rb_j.overflow) is False
    assert float(rb_t.dmax2) == 0.0 and float(rb_t.dispx.abs().max()) == 0.0
    # coordinates are wrapped into [0, box) by the rebuild
    live = rb_t.occ > 0.5
    assert bool(((rb_t.xg[live] >= 0) & (rb_t.xg[live] < md_t.box)).all())


def test_migrate_reference_is_the_permutation():
    """The plain version against a slot-by-slot loop on random injective
    codes (several movers into one target cell included)."""
    cps, cap, n_fields = 4, 3, 2
    rng = np.random.default_rng(0)
    scode = np.full((cps, cap, cps), -1, np.int32)
    taken = set()
    for cx in range(cps):
        for b in range(cap):
            for cy in range(cps):
                if rng.random() < 0.3:
                    continue
                d = int(rng.integers(9))
                tx, ty = (cx + d // 3 - 1) % cps, (cy + d % 3 - 1) % cps
                free = [a for a in range(cap) if (tx, a, ty) not in taken]
                if free:
                    a = free[0]
                    taken.add((tx, a, ty))
                    scode[cx, b, cy] = d * cap + a
    fields = rng.standard_normal((n_fields, cps, cap, cps)).astype(np.float32)
    fills = [7.0, -1.0]
    want = np.empty_like(fields)
    want[0], want[1] = fills
    for cx in range(cps):
        for b in range(cap):
            for cy in range(cps):
                code = scode[cx, b, cy]
                if code >= 0:
                    d, a = divmod(int(code), cap)
                    tx, ty = (cx + d // 3 - 1) % cps, (cy + d % 3 - 1) % cps
                    want[:, tx, a, ty] = fields[:, cx, b, cy]
    got = migrate_cuda.migrate_reference(torch.from_numpy(scode), torch.from_numpy(fields), fills)
    np.testing.assert_array_equal(got.numpy(), want)


def _random_codes(cps, cap, rng):
    """Random injective source-frame codes on the (cps, cap, cps) frame
    (several movers into one target cell included)."""
    scode = np.full((cps, cap, cps), -1, np.int32)
    taken = set()
    for cx in range(cps):
        for b in range(cap):
            for cy in range(cps):
                if rng.random() < 0.3:
                    continue
                d = int(rng.integers(9))
                tx, ty = (cx + d // 3 - 1) % cps, (cy + d % 3 - 1) % cps
                free = [a for a in range(cap) if (tx, a, ty) not in taken]
                if free:
                    taken.add((tx, free[0], ty))
                    scode[cx, b, cy] = d * cap + free[0]
    return scode


def test_migrate_packed_plain_matches_jax_kernel():
    """B2 on the packed layout (cps 8, R 4, G 2: every direction crosses a
    block seam somewhere): the plain version bit-equal to the JAX package's
    ``make_migrate_kernel(..., rows_per_block=4)`` in interpret mode, slot
    by slot and in particle order through a carried id field, and to the
    unpacked migrate on the same codes."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_cuda_packed import pack, unpack

    cps, cap, r = 8, 3, 4
    rng = np.random.default_rng(1)
    scode = torch.from_numpy(_random_codes(cps, cap, rng))
    values = torch.from_numpy(rng.standard_normal((cps, cap, cps)).astype(np.float32))
    ids = torch.arange(cps * cap * cps, dtype=torch.float32).view(cps, cap, cps)
    fills = [7.0, -1.0]
    scode_p = pack(scode, r)
    fields_p = torch.stack([pack(values, r), pack(ids, r)])
    got = migrate_cuda.migrate(scode_p, fields_p, fills, rows_per_block=r)
    assert tuple(got.shape) == (2, 2, cap, 32)
    pad = ((0, 0), (0, 0), (0, 128 - 32))
    scode_j = jnp.asarray(np.pad(scode_p.numpy(), pad, constant_values=-1))
    fields_j = [jnp.asarray(np.pad(f.numpy(), pad)) for f in fields_p]
    out_j = jax_make_migrate_kernel(cps, cap, r, 2, fills, interpret=True)(scode_j, *fields_j)
    for f in range(2):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(out_j[f])[:, :, :32])
    moved = got[1] >= 0
    assert torch.equal(got[0][moved], values.reshape(-1)[got[1][moved].long()])
    flat = migrate_cuda.migrate(scode, torch.stack([values, ids]), fills)
    assert torch.equal(torch.stack([unpack(g, r) for g in got]), flat)


def test_migrate_wrapper_rejects_bad_inputs():
    scode = torch.full((4, 3, 4), -1, dtype=torch.int32)
    fields = torch.zeros((2, 4, 3, 4))
    with pytest.raises(TypeError):
        migrate_cuda.migrate(scode.long(), fields, [0.0, 0.0])
    with pytest.raises(TypeError):
        migrate_cuda.migrate(scode, fields.double(), [0.0, 0.0])
    with pytest.raises(ValueError, match="grid"):
        migrate_cuda.migrate(scode[:, :2], fields, [0.0, 0.0])
    with pytest.raises(ValueError, match="fills"):
        migrate_cuda.migrate(scode, fields, [0.0])
    with pytest.raises(ValueError, match="contiguous"):
        migrate_cuda.migrate(scode.transpose(0, 2), fields, [0.0, 0.0])
    with pytest.raises(ValueError):
        migrate_cuda.migrate(scode.to("meta"), fields.to("meta"), [0.0, 0.0])
    with pytest.raises(ValueError, match="R = 2"):  # 4 cell rows do not pack into 4 lanes
        migrate_cuda.migrate(scode, fields, [0.0, 0.0], rows_per_block=2)
