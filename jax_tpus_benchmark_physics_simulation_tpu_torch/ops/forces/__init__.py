"""Periodic boundaries, the dense Lennard-Jones oracle and Newtonian gravity."""
