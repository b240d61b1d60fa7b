"""PyTorch + CUDA port of the particle-simulation engine.

The JAX package ``jax_tpus_benchmark_physics_simulation_tpu`` beside this
one is the reference; this package ports it slice by slice to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). It imports ``torch``
and ``numpy`` only, never ``jax`` or the JAX package.

- ``core``     MDConfig, ParticleState and the step-loop runners
- ``ops``      periodic boundaries, the dense LJ formula, velocity Verlet,
               the CUDA kernels, the neighbor-list and cell-dense force
               paths, the grid-resident MD engines (2D, 3D), observables
- ``models``   ``lj_fluid``: the LJ fluid workload on every force path
- ``interop``  carries state exported from the JAX package into the port
- ``cli``      ``md`` subcommand
"""

__version__ = "0.1.0"
