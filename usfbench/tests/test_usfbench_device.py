"""A device path that finds no card fails; it never falls back to the
CPU. The benchmark's command without a card exits non-zero and prints no
result line."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from usfbench.trace import DeviceTrace

ROOT = Path(__file__).resolve().parents[2]


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable")
    proc = subprocess.run(
        [sys.executable, "usfbench/run.py", "--workload", "smollm-360m.train-pair",
         "--seed", "2147483905", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_trace_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceTrace(0.0, 1.0).begin()


def test_run_without_the_program_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the harness, the
    command exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "usfbench", tmp_path / "usfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "usfbench/run.py", "--workload", "smollm-360m.train-pair",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.gpu
def test_weights_drawn_on_the_card_repeat_from_the_seed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from usfbench.weights import make_params
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model

    specs = build_model(get_smoke("smollm_360m")).param_specs()
    a = make_params(specs, "float32", 2 ** 40 + 3, "cuda", 0.02)
    b = make_params(specs, "float32", 2 ** 40 + 3, "cuda", 0.02)
    assert a["unembed"].device.type == "cuda"
    assert torch.equal(a["unembed"], b["unembed"])
