"""Workloads on the engine: the LJ fluid (2D and 3D) and the n-body merger."""
