"""PyTorch + CUDA port of the particle-simulation engine.

The JAX package ``jax_tpus_benchmark_physics_simulation_tpu`` beside this
one is the reference; this package ports it slice by slice to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a). It imports ``torch``
and ``numpy`` only, never ``jax`` or the JAX package.

- ``core``     MDConfig and ParticleState
- ``ops``      periodic boundaries, dense LJ oracle, cell-grid geometry,
               the CUDA kernels and the grid-resident MD engines (2D, 3D),
               observables
- ``models``   ``lj_fluid``: the LJ fluid workload, 2D and 3D
- ``interop``  carries state exported from the JAX package into the port
- ``cli``      ``md`` subcommand
"""

__version__ = "0.1.0"
