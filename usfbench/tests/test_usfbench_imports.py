"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port: judged in a fresh interpreter by the
whole top-level name of every module in ``sys.modules`` (the port's name
begins with the JAX package's)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HARNESS = ["usfbench.run", "usfbench.harness", "usfbench.generator", "usfbench.trace",
           "usfbench.counting", "usfbench.weights", "usfbench.control", "usfbench.sweep",
           "usfbench.jobs.serve", "usfbench.jobs.train"]
REFERENCE = ["usfbench.reference.dense", "usfbench.reference.train",
             "usfbench.reference.data"]

PROBE = """
import importlib, importlib.util, json, sys
from pathlib import Path
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
for name in json.loads(sys.argv[2]):
    importlib.import_module(name)
if sys.argv[3] == "1":
    import usfbench.harness as h
    for p in sorted((Path(sys.argv[1]) / "usfbench" / "metrics").glob("*.py")):
        h.load_metric(p.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(modules, metrics=False):
    proc = subprocess.run([sys.executable, "-c", PROBE, str(ROOT), json.dumps(modules),
                           "1" if metrics else "0"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", HARNESS)
def test_harness_module_loads_no_jax(module):
    top = _top_level([module])
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top & {"jax", "jaxlib", "flax", "repro"}


def test_metric_readers_and_the_program_they_drive_load_no_jax():
    top = _top_level(HARNESS + ["repro_torch.serve.engine", "repro_torch.train.trainer"],
                     metrics=True)
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("module", REFERENCE)
def test_reference_loads_nothing_of_the_port(module):
    top = _top_level([module])
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
