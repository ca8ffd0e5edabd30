"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its copies of the scheduler, the broker, the trace layer and
the configs do not drift."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

#: files of the JAX package that the port carries as mechanical copies
COPIED = sorted(
    [f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob("*.py")]
    + [f"core/{n}.py" for n in (
        "__init__", "task", "topology", "lease", "stats", "adaptive",
        "arbiter", "scheduler", "threads", "sync", "simtask", "autockpt")]
    + [f"core/policies/{n}.py" for n in (
        "__init__", "base", "sched_coop", "sched_fair", "sched_rr")]
    + ["core/deadline.py", "core/events.py", "launch/rescale.py",
       "analysis/hlo.py"]
    + [f"ipc/{n}.py" for n in (
        "__init__", "protocol", "faults", "broker", "client")]
    + [f"trace/{n}.py" for n in (
        "__init__", "schema", "recorder", "replayer", "ab", "adapter", "synth")]
)

_PROBE = r"""
import importlib, json, os, sys
from pathlib import Path
sys.modules["jax"] = None  # any attempt to import jax raises ImportError
src = Path(sys.argv[1])
mods = sorted(
    ".".join(p.relative_to(src).with_suffix("").parts).removesuffix(".__init__")
    for p in (src / "repro_torch").rglob("*.py")
)
env = dict(os.environ)
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
import torch.distributed as dist
env_changed = sorted(k for k in set(env) | set(os.environ) if env.get(k) != os.environ.get(k))
print(json.dumps({"mods": mods, "bad": bad, "env_changed": env_changed,
                  "process_group": dist.is_available() and dist.is_initialized()}))
"""

#: the training path's modules (ROADMAP M10), named so that the check
#: above fails if one of them goes missing from the package
TRAINING = ["repro_torch.train", "repro_torch.train.loss", "repro_torch.train.step",
            "repro_torch.train.trainer", "repro_torch.optim",
            "repro_torch.optim.optimizers", "repro_torch.optim.schedules",
            "repro_torch.data", "repro_torch.data.pipeline", "repro_torch.ckpt",
            "repro_torch.ckpt.checkpoint"]


#: the distribution and launch modules (ROADMAP M11), named likewise
DISTRIBUTION = ["repro_torch.runtime.sharding", "repro_torch.runtime.dist",
                "repro_torch.runtime.pipeline", "repro_torch.launch.mesh",
                "repro_torch.launch.dryrun", "repro_torch.launch.elastic",
                "repro_torch.launch.inputs", "repro_torch.analysis",
                "repro_torch.analysis.hlo", "repro_torch.analysis.roofline"]


#: the twins of ``examples/`` (ROADMAP M12), named likewise
EXAMPLES = ["repro_torch.examples", "repro_torch.examples.oversubscribed_serving",
            "repro_torch.examples.co_execution_training",
            "repro_torch.examples.nested_runtime_matmul",
            "repro_torch.examples.quickstart"]


@pytest.fixture(scope="module")
def probe():
    """Every repro_torch module and chip_smoke.py imported in a subprocess
    where ``import jax`` raises: {"mods": imported, "bad": repro.* loaded,
    "env_changed": environment keys the imports set or changed,
    "process_group": whether one is up after them}."""
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}")
    r = subprocess.run([sys.executable, "-c", _PROBE, str(SRC)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout)


def test_port_imports_without_jax_or_the_jax_package(probe):
    assert len(probe["mods"]) >= 20
    assert probe["bad"] == [], probe["bad"]


@pytest.mark.parametrize("module", TRAINING)
def test_training_module_imports_without_jax(module, probe):
    assert module in probe["mods"]


@pytest.mark.parametrize("module", DISTRIBUTION)
def test_distribution_module_imports_without_jax(module, probe):
    assert module in probe["mods"]


@pytest.mark.parametrize("module", EXAMPLES)
def test_example_module_imports_without_jax(module, probe):
    assert module in probe["mods"]


def test_quickstart_is_a_copy_of_the_example():
    """``examples/quickstart.py`` imports only ``repro.core``, so the port
    carries it as the same mechanical copy as ``COPIED``."""
    original = (ROOT / "examples" / "quickstart.py").read_text()
    copy = (SRC / "repro_torch" / "examples" / "quickstart.py").read_text()
    assert copy == re.sub(r"\brepro\.", "repro_torch.", original)


def test_importing_the_port_touches_no_distributed_state_or_environment(probe):
    """No module starts a process group or edits the environment when
    imported (the JAX dry run sets XLA_FLAGS at import; the port's opens a
    fake world per cell)."""
    assert probe["process_group"] is False
    assert probe["env_changed"] == []


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_the_jax_package(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    assert copy == re.sub(r"\brepro\.", "repro_torch.", original)


def test_port_get_arch_reads_the_port_configs():
    from repro_torch.configs.base import get_arch, list_archs

    cfg = get_arch("smollm-360m")
    assert type(cfg).__module__ == "repro_torch.configs.base"
    assert len(list_archs()) == 10
