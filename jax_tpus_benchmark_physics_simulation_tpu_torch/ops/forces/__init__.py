"""Periodic boundaries and the dense Lennard-Jones oracle."""
