"""No module a run imports has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``theanompi_tpu`` (compared whole: the port,
``theanompi_tpu_torch``, is allowed)."""

import subprocess
import sys

from port_bench import spec
from port_bench.run import FORBIDDEN, forbidden_modules


def test_forbidden_compares_whole_names():
    mods = ["theanompi_tpu_torch", "theanompi_tpu_torch.models.llama",
            "jaxtyping", "flaxen", "jax", "jax.numpy", "jaxlib.xla",
            "flax.linen", "theanompi_tpu", "theanompi_tpu.ops"]
    assert forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "theanompi_tpu",
         "theanompi_tpu.ops"])
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "theanompi_tpu"}


def test_a_cpu_run_of_every_driver_loads_none(tmp_path):
    """Both drivers run a tiny cell on the CPU in a fresh process, then
    the loaded modules are read."""
    code = f"""
import sys, time
sys.path.insert(0, {str(spec.ROOT)!r})
import torch
from port_bench import calibrate, check, flops, run, spec, trace, traffic
from port_bench.drivers import Run, serve, train
from port_bench.tests.helpers import tiny_cell
dev = torch.device("cpu")
for cfg, mix, drv in (("tiny.json", "tiny_train.json", train),
                      ("tiny.json", "tiny_chat.json", serve)):
    drv.run(Run(tiny_cell(cfg, mix), seed=3, seconds=0.3, trace=True,
                t_start=time.monotonic(), device=dev))
for m in spec.load_benchmark()["per_layer"]:
    spec.load_reader(m["name"])
print("BAD", run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout.splitlines()[-1]
