"""Observables: kinetic energy, temperature, radial distribution."""
