"""Every module of the port, and ``chip_smoke.py``, imports with ``jax``,
``flax`` and ``optax`` absent: the card has none of them. A fresh
interpreter marks them missing (``sys.modules[name] = None`` makes an
import of them raise) and imports each module of the package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None
import jax_tpus_benchmark_physics_simulation_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
leaked = sorted(m for m in sys.modules if m.startswith("jax_tpus_benchmark_physics_simulation_tpu.")
                or m == "jax_tpus_benchmark_physics_simulation_tpu")
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_flax_optax():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    n = int(out.stdout.strip().splitlines()[-1])
    assert n >= 60  # every module, the new mc package and em3/vmc models among them
    for mod in ("mc.vmc", "mc.dmc", "mc.adam", "models.em_three_particles", "models.quantum_oscillator",
                "utils.debug", "utils.prng", "ops.forces.em"):
        assert os.path.exists(os.path.join(ROOT, "jax_tpus_benchmark_physics_simulation_tpu_torch",
                                           *mod.split(".")) + ".py")
