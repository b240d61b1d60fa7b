"""PyTorch + CUDA port of the particle-simulation engine.

The JAX package ``jax_tpus_benchmark_physics_simulation_tpu`` beside this
one is the reference; this package ports it slice by slice to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). It imports ``torch``
and ``numpy`` only, never ``jax`` or the JAX package.

- ``core``     MDConfig, NBodyConfig, BenchConfig, ParticleState and the
               step-loop runners
- ``ops``      periodic boundaries, the dense LJ and gravity formulas,
               velocity Verlet, RK4 and dopri5, the CUDA kernels, the
               neighbor-list and cell-dense force paths, the grid-resident
               MD engines (2D, 3D), observables (GW strain, Lyapunov too)
- ``models``   ``lj_fluid`` (the LJ fluid on every force path) and
               ``nbody_merger``
- ``bench``    the op benchmark suite and its crash-isolated sweep
- ``report``   CSV export
- ``interop``  carries state exported from the JAX package into the port
- ``cli``      ``md``, ``nbody``, ``bench`` and ``devices`` subcommands
"""

__version__ = "0.1.0"
