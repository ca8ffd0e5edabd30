"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its copies of the scheduler, the broker, the trace layer and
the configs do not drift."""

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
    + ["core/deadline.py", "core/events.py", "launch/rescale.py"]
    + [f"ipc/{n}.py" for n in (
        "__init__", "protocol", "faults", "broker", "client")]
    + [f"trace/{n}.py" for n in (
        "__init__", "schema", "recorder", "replayer", "ab", "adapter", "synth")]
)

_PROBE = r"""
import importlib, sys
from pathlib import Path
sys.modules["jax"] = None  # any attempt to import jax raises ImportError
src = Path(sys.argv[1])
mods = sorted(
    ".".join(p.relative_to(src).with_suffix("").parts).removesuffix(".__init__")
    for p in (src / "repro_torch").rglob("*.py")
)
for m in mods:
    importlib.import_module(m)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(len(mods), bad)
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}")
    r = subprocess.run([sys.executable, "-c", _PROBE, str(SRC)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.split(maxsplit=1)
    assert int(n) >= 20
    assert bad.strip() == "[]", bad


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
