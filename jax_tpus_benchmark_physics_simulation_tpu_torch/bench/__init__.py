"""The op benchmark suite (port of the JAX package's ``bench``): ops, FLOP
models, the timing harness and sweep, system info, and the crash-isolated
sweep (``isolate`` + ``sweep_worker``)."""

from jax_tpus_benchmark_physics_simulation_tpu_torch.bench import flops, ops
from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.runners import (
    BenchContext,
    compute_core_candidates,
    run_sweep,
)
from jax_tpus_benchmark_physics_simulation_tpu_torch.bench.sysinfo import (
    device_rows,
    safe_device_count,
    system_info,
)

__all__ = [
    "run_sweep",
    "compute_core_candidates",
    "BenchContext",
    "system_info",
    "device_rows",
    "safe_device_count",
    "ops",
    "flops",
]
