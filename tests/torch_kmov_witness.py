"""Where the 3D rebuild's mover flag rises for ``lj_fluid``'s 3D engine
(``GridMD3``, hybrid B5/B4 windows, ``migrate_k_mov=8``) at the two-device
geometry of N = 100,000 (skin rounded to 2 devices: 18 cells per side), and
whether the JAX package's allocation and mover rule rise on the same state.

Two steps, on two machines:

    # on the card, the port only: lj_fluid's phases (2000 + 2000 steps)
    # on k_mov 8 and k_mov 16 at 18 cells per side and on k_mov 8 at the
    # one-device geometry, every rebuild's largest mover count in a cell,
    # and the first pre-rebuild state with more than 8 movers in a cell
    python tests/torch_kmov_witness.py dump out/kmov_witness.npz

    # on the CPU, the JAX package: its ``GridMD3._migration_dest3`` and its
    # B6 ``compact_fields`` mover rule on that state (no Pallas kernel runs)
    JAX_PLATFORMS=cpu python tests/torch_kmov_witness.py check out/kmov_witness.npz

A mover is an occupied slot whose particle left its cell since the last
rebuild (``dcode != 13``); B6 with ``k_mov`` raises its flag where a cell
has more than ``k_mov`` of them (``migrate_cuda3.mover_overflow``; JAX:
``migrate_pallas3.compact_fields``)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K_MOV = 8
STAY = 13


def _movers_per_cell(scode, cap: int):
    """Largest number of movers in one source cell of a code grid."""
    import torch

    is_mov = (scode >= 0) & (torch.div(scode, cap, rounding_mode="floor") != STAY)
    return int(is_mov.sum(1).max())


def _run(cfg, md, device, first: dict) -> dict:
    """``lj_fluid``'s equilibration and production on ``md`` with every
    rebuild's largest mover count recorded; the first state with more than
    ``K_MOV`` movers in a cell goes into ``first`` (if still empty)."""
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid

    phase = ["eq"]
    counts = {"eq": [], "prod": []}
    rebuild = md._rebuild_migrate

    def hooked(s):
        _, _, _, scode, _, _, _ = md._migration_dest(s)
        m = _movers_per_cell(scode, md.cap)
        counts[phase[0]].append(m)
        if m > K_MOV and not first:
            first.update(
                xg=s.xg.cpu().numpy(), yg=s.yg.cpu().numpy(), zg=s.zg.cpu().numpy(),
                occ=s.occ.cpu().numpy(), scode=scode.cpu().numpy(), movers=m,
                phase=phase[0], rebuild=len(counts[phase[0]]),
            )
        return rebuild(s)

    md._rebuild_migrate = hooked
    state_eq, ovf_eq = lj_fluid.equilibrate(cfg, lj_fluid.init_state(cfg, device), md)
    kt_eq = float(lj_fluid.temperature(state_eq))
    cadence = lj_fluid.production_cadence(cfg, kt_eq, md)
    phase[0] = "prod"
    _, _, ovf_prod = lj_fluid.production(cfg, state_eq, cadence, md)
    return dict(counts=counts, cadence=cadence, overflow_eq=bool(ovf_eq), overflow_prod=bool(ovf_prod))


def dump(path: str, device: str, n: int = 100_000, steps: int = 2000) -> None:
    import torch

    from jax_tpus_benchmark_physics_simulation_tpu_torch.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu_torch.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.cell_dense import make_cell_grid_fn
    from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.kernels.grid_md3 import GridMD3
    from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel import scaling

    base = override(
        MDConfig(), n=n, dim=3, rho=0.8, kt=1.0, dt=1e-3, cutoff=2.5, init="lattice",
        force_impl="grid", compensated=True, eq_steps=steps, prod_steps=steps, sample_every=100,
    )
    first: dict = {}
    meta = {}
    for label, n_dev, k_mov in (("cps18_kmov8", 2, 8), ("cps18_kmov16", 2, 16), ("one_device_kmov8", 1, 8)):
        cfg = override(base, n=scaling._round_to_divisible_n(base.n, base, [1, 2]))
        cfg = override(cfg, skin=lj_fluid.resolve_skin(cfg, "grid", n_devices=n_dev))
        gf = make_cell_grid_fn(cfg.box_size, cfg.cutoff, cfg.n, dim=3, skin=cfg.skin, rho=cfg.rho)
        md = GridMD3(gf, sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt, compensated=cfg.compensated,
                     static_cov="auto", migrate_k_mov=k_mov, device=device)
        got = first if label == "cps18_kmov8" else {}
        out = _run(cfg, md, device, got)
        eq, prod = out["counts"]["eq"], out["counts"]["prod"]
        print(f"{label}: N={cfg.n}, skin {cfg.skin:.4f}, {gf.cells_per_side} cells per side, cap {gf.capacity}, "
              f"k_mov {k_mov}; equilibration {len(eq)} rebuilds, movers in a cell max {max(eq, default=0)}, "
              f"rebuilds above {K_MOV}: {sum(m > K_MOV for m in eq)}; production cadence {out['cadence']}, "
              f"{len(prod)} rebuilds, max {max(prod, default=0)}, above {K_MOV}: "
              f"{sum(m > K_MOV for m in prod)}; overflow eq {out['overflow_eq']} prod {out['overflow_prod']}",
              flush=True)
        if label == "cps18_kmov8":
            meta = dict(n=cfg.n, rho=cfg.rho, box=cfg.box_size, cutoff=cfg.cutoff, skin=cfg.skin,
                        cps=gf.cells_per_side, cap=gf.capacity)
        del md
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if not first:
        print(f"no rebuild had more than {K_MOV} movers in a cell at 18 cells per side: nothing dumped")
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **first, **meta)
    print(f"first state with {first['movers']} movers in a cell: {first['phase']} rebuild {first['rebuild']}; "
          f"written to {path}", flush=True)


def check(path: str) -> None:
    import jax.numpy as jnp

    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import make_cell_grid_fn
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3, GridMD3State
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.migrate_pallas3 import make_migrate_kernel3

    d = np.load(path)
    n, cps, cap = int(d["n"]), int(d["cps"]), int(d["cap"])
    gf = make_cell_grid_fn(float(d["box"]), float(d["cutoff"]), n, dim=3, skin=float(d["skin"]),
                           rho=float(d["rho"]))
    if (gf.cells_per_side, gf.capacity) != (cps, cap):
        raise SystemExit(f"JAX's grid {gf.cells_per_side} cells, cap {gf.capacity}; the port's {cps}, {cap}")
    md = GridMD3(gf, dt=1e-3, migrate_k_mov=K_MOV, interpret=True)
    pad = md.lanes - cps * cps

    def grid(name, fill=0.0):
        return jnp.asarray(np.pad(d[name], ((0, 0), (0, 0), (0, pad)), constant_values=fill))

    zero = jnp.zeros(md.grid_shape, jnp.float32)
    s = GridMD3State(
        xg=grid("xg", md.sentinel), yg=grid("yg", md.sentinel), zg=grid("zg", md.sentinel),
        vxg=zero, vyg=zero, vzg=zero, fxg=zero, fyg=zero, fzg=zero, occ=grid("occ"),
        pid=jnp.full(md.grid_shape, -1, jnp.int32), dispx=zero, dispy=zero, dispz=zero,
        dmax2=jnp.zeros((), jnp.float32), overflow=jnp.zeros((), bool), time=jnp.zeros((), jnp.float32),
    )
    xw, _, _, scode, _, _, alloc_overflow = md._migration_dest3(s)
    scode_np = np.asarray(scode)[:, :, : cps * cps]
    same = bool(np.array_equal(scode_np, d["scode"]))
    flags = {}
    for k in (K_MOV, 16):
        mig = make_migrate_kernel3(cps, cap, 1, [md.sentinel], interpret=True, compact=True, k_mov=k)
        _, _, counts, mov_of = mig.compact_fields(scode, [xw])
        flags[k] = bool(mov_of)
    movers = int(np.asarray(counts)[:, :, : cps * cps].max())
    print(f"JAX GridMD3._migration_dest3 on the port's state ({d['phase']} rebuild {int(d['rebuild'])}, "
          f"{cps} cells per side, cap {cap}): codes bit-identical to the port's: {same}; movers in a cell "
          f"max {movers} (port {int(d['movers'])}); compact_fields mover flag at k_mov {K_MOV}: "
          f"{flags[K_MOV]}, at k_mov 16: {flags[16]}; allocation overflow {bool(alloc_overflow)}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("step", choices=("dump", "check"))
    ap.add_argument("path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=100_000, help="dump: particles before the rounding")
    ap.add_argument("--steps", type=int, default=2000, help="dump: equilibration and production steps each")
    args = ap.parse_args()
    dump(args.path, args.device, args.n, args.steps) if args.step == "dump" else check(args.path)


if __name__ == "__main__":
    main()
