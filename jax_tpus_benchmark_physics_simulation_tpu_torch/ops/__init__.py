"""Force fields, kernels and observables."""
