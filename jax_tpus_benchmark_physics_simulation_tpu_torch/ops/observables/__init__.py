"""Observables: kinetic energy, temperature, radial distribution, MSD, GW strain, Lyapunov exponents."""
