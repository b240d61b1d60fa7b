"""Workloads on the engine: the 2D LJ fluid."""
