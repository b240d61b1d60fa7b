"""System and device introspection (port of the JAX package's
``bench/sysinfo.py``; reference ``get_system_info``, tpus_benchmark...:81-122,
and ``utils/jax_devices.py`` without its import-time side effects).

Nothing here runs at import. On ``cuda`` these functions initialize CUDA in
the calling process, so the crash-isolated sweep calls them only in its
worker.
"""

from __future__ import annotations

import platform
from typing import List

import torch


def safe_device_count(device="cuda") -> int:
    """Visible CUDA devices (0 if CUDA cannot be queried); 1 for the CPU."""
    if torch.device(device).type == "cpu":
        return 1
    try:
        return int(torch.cuda.device_count())
    except Exception:
        return 0


def device_rows(device="cuda") -> List[dict]:
    """One dict per device (index/kind/id/process/platform)."""
    if torch.device(device).type == "cpu":
        return [{"index": 0, "device_kind": platform.processor() or platform.machine(),
                 "id": 0, "process_index": 0, "platform": "cpu"}]
    return [
        {"index": i, "device_kind": torch.cuda.get_device_name(i), "id": i,
         "process_index": 0, "platform": "cuda"}
        for i in range(safe_device_count(device))
    ]


def system_info(device="cuda") -> dict:
    """Host, torch and device facts, and the float32 settings a sweep runs
    with: float32 matmuls at ``torch.get_float32_matmul_precision()`` (the
    sweep requires "highest", no TF32) and convolutions with cuDNN's TF32
    off (``bench/ops.op_conv``)."""
    info = {
        "os": f"{platform.system()} {platform.release()}",
        "machine": platform.machine(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "conv_tf32": False,
    }
    try:
        import psutil

        info["cpu_logical"] = psutil.cpu_count(logical=True)
        info["cpu_physical"] = psutil.cpu_count(logical=False)
        info["ram_gb"] = round(psutil.virtual_memory().total / 1024**3, 2)
    except Exception:
        pass
    dev = torch.device(device)
    info["backend"] = dev.type
    info["device_count"] = safe_device_count(dev)
    if dev.type == "cuda":
        try:
            props = torch.cuda.get_device_properties(dev.index or 0)
            info["device_kind"] = props.name
            info["device_memory_gb"] = round(props.total_memory / 1024**3, 2)
        except Exception as e:
            info["backend"] = f"unavailable ({e})"
    else:
        info["device_kind"] = device_rows(dev)[0]["device_kind"]
    return info
