"""A cell at smoke size on the CPU: the same harness, jobs, traffic,
reference and metrics, with the configuration's widths and the cell's
sizes cut so that a run takes seconds."""

from __future__ import annotations

import json
import time
from pathlib import Path

from usfbench.harness import Context, benchmark_with, run_cell

ROOT = Path(__file__).resolve().parents[2]

SMOKE_CONF = {"hidden_size": 60, "intermediate_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 3, "num_key_value_heads": 1, "head_dim": 20,
              "vocab_size": 256, "compute_dtype": "float32"}
SMOKE_SERVE = {"kind": "serve", "count": 2, "max_batch": 4, "max_len": 64, "nice": 10}
SMOKE_TRAIN = {"kind": "train", "global_batch": 4, "seq_len": 32, "microbatches": 2,
               "peak_lr": 0.001, "warmup": 2, "schedule_steps": 1000}
SMOKE_MIX = {"prompt": {"median": 6, "sigma": 0.5, "min": 2, "max": 12},
             "output": {"median": 4, "sigma": 0.5, "min": 2, "max": 8}}


#: the serving cell: its files are in ``usfbench/`` and run here, but it is
#: not (yet) a cell of BENCHMARK.json (PERF.md, Open questions)
SERVE_CELL = "smollm-360m.serve-with-train"


def bench() -> dict:
    """BENCHMARK.json, with the serving cell and its metrics added from its
    cell file."""
    return benchmark_with(json.loads((ROOT / "BENCHMARK.json").read_text()), SERVE_CELL)


def smoke_overrides(workload: str, rate: float = 4.0) -> dict:
    """What cuts the cell to smoke size: the widths, the jobs, the mix."""
    cell = json.loads((ROOT / "usfbench" / "cells" / f"{workload}.json").read_text())
    jobs = []
    for spec in cell["jobs"]:
        small = SMOKE_SERVE if spec["kind"] == "serve" else SMOKE_TRAIN
        jobs.append(dict(small, count=spec.get("count", 1)))
    over = {"conf": SMOKE_CONF,
            "cell": {"jobs": jobs, "setup_limit_s": 120.0,
                     "check": {"serve_sample": 6}}}
    if "traffic" in cell:
        over["cell"]["traffic"] = dict(cell["traffic"], rate_per_s=rate, drain_s=30.0)
        over["mix"] = SMOKE_MIX
    return over


def smoke_context(workload: str, *, seed: int = 1234567, seconds: float = 2.0,
                  trace: bool = False, rate: float = 4.0) -> Context:
    """The cell at smoke size, held to the cell's own limits."""
    return Context(workload, seed=seed, seconds=seconds, trace=trace, device="cpu",
                   bench=bench(), t_proc0=time.monotonic(),
                   overrides=smoke_overrides(workload, rate))


def smoke_run(workload: str, **kw) -> tuple[Context, dict]:
    ctx = smoke_context(workload, **kw)
    return ctx, run_cell(ctx, log=lambda m: None)
