"""Co-executed training jobs (paper §5.6 analogue) — REAL training, e2e.

The twin of ``examples/co_execution_training.py`` on the port. Two
Trainer jobs (different architectures) share a USF runtime: each trains a
run with checkpointing; blocking points (data prefetch, inter-step yields)
let the scheduler interleave them per the per-job quantum. A real model
trained with loss decreasing and checkpoint/restart.

The trainers run on the CUDA card (attention through K2) unless
``--device cpu`` is given; ``configs`` replaces the smoke configs.

Run:  PYTHONPATH=src python -m repro_torch.examples.co_execution_training [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional

from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import SchedCoop
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.models.base import resolve_device
from repro_torch.train.trainer import Trainer, TrainerConfig

#: the example's jobs: (name, architecture, seed)
JOBS = (("smollm", "smollm_360m", 0), ("danube", "h2o_danube_3_4b", 1))


def run(configs: Optional[dict] = None, *, steps: int = 120, peak_lr: float = 1e-2,
        ckpt_every: int = 50, keep: int = 3, device=None,
        ckpt_dirs: Optional[dict] = None, verbose: bool = True) -> dict:
    """The example, end to end. ``configs`` maps a job's name to its config
    (default: the smoke configs of ``JOBS``); ``device=None`` is the CUDA
    card. A job named in ``ckpt_dirs`` checkpoints into that directory and
    resumes from its latest checkpoint (a step-0 checkpoint carries given
    weights in); the others start fresh in a temporary directory, as the
    example does.

    Returns each job's ``losses`` and ``step_s`` (wall seconds a step),
    ``ckpt_s`` (the checkpoints' host copy and write seconds, by step),
    ``wall_s`` and the runtime's ``stats``."""
    dev = resolve_device(device)
    configs = configs or {name: get_smoke(arch) for name, arch, _ in JOBS}
    seeds = {name: seed for name, _, seed in JOBS}
    ckpt_dirs = ckpt_dirs or {}
    usf = UsfRuntime(Topology(1, 1), SchedCoop(quantum=0.25))
    results = {}

    def train_job(name, cfg, seed):
        def body():
            with tempfile.TemporaryDirectory() as d:
                t = Trainer(
                    cfg,
                    TrainerConfig(steps=steps, global_batch=4, seq_len=64,
                                  ckpt_dir=ckpt_dirs.get(name, d),
                                  ckpt_every=ckpt_every, keep=keep,
                                  peak_lr=peak_lr, warmup=10, seed=seed),
                    usf=usf, device=dev,
                )
                t0 = time.monotonic()
                t.run(resume=name in ckpt_dirs)
                results[name] = {
                    "losses": [m["loss"] for m in t.metrics_log],
                    "step_s": [m["wall_s"] for m in t.metrics_log],
                    "ckpt_s": t.ckpt_times, "wall_s": time.monotonic() - t0}

        return body

    try:
        jobs = {name: Job(f"job-{name}") for name in configs}
        tasks = [
            usf.create(train_job(name, cfg, seeds.get(name, 0)), job=jobs[name],
                       name=f"train-{name}")
            for name, cfg in configs.items()
        ]
        for t in tasks:
            assert usf.join(t, timeout=3600.0)
        s = usf.stats()
    finally:
        usf.shutdown()

    if verbose:
        for name, r in results.items():
            losses = r["losses"]
            print(f"{name}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
                  f"over {len(losses)} steps "
                  f"({'DECREASED' if losses[-1] < losses[0] - 0.5 else 'flat'})")
        print(f"scheduler: dispatches={s['dispatches']} yields={s['yields']} "
              f"preemptions={s['preemptions']} (SCHED_COOP: must be 0)")
    assert s["preemptions"] == 0
    return {"jobs": results, "stats": s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(steps=args.steps, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
