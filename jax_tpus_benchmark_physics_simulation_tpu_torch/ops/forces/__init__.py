"""Periodic boundaries, the dense Lennard-Jones oracle, Newtonian gravity and
the 2D Lorentz acceleration (``Lorentz2D``)."""

from jax_tpus_benchmark_physics_simulation_tpu_torch.ops.forces.em import Lorentz2D

__all__ = ["Lorentz2D"]
