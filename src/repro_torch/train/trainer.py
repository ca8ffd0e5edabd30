"""Production training loop: checkpoint/restart, async saves, co-execution
awareness, spans of each step. Port of ``repro/train/trainer.py``.

Fault-tolerance model:
  * deterministic data stream keyed by step — restart replays exactly;
  * atomic async checkpoints every ``ckpt_every`` steps, on the JAX
    package's layout (a JAX checkpoint resumes here, and back);
  * ``Trainer.run`` resumes from the latest checkpoint automatically;
  * under a UsfRuntime, the step's call site is an auto-checkpoint and the
    loader's wait a cooperative blocking point, so a co-located job can
    fill this job's stalls (§5.6).

The step runs on ``device`` (None: the CUDA card) and updates the state in
place; ``float(metrics["loss"])`` is its one host sync. With the span sink
armed (``runtime/spans.py``) each step records ``train.step`` (the
loader's wait, the copy to the device, the step's dispatch and the sync
as its children) and the yield after it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core.autockpt import preemptible
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMDataset, to_tensors
from repro_torch.models.base import init_tree, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.runtime import spans
from repro_torch.runtime.sharding import Sharder
from repro_torch.train.step import init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep: int = 3
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup: int = 10
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, *, sharder: Optional[Sharder] = None,
                 usf=None, on_step: Optional[Callable[[int, dict], None]] = None,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.sharder = sharder or Sharder(None)
        self.usf = usf
        self.on_step = on_step
        self.model = build_model(cfg)
        self.metrics_log: list[dict] = []
        #: (step, host copy s, write s) of each checkpoint ``run`` saved
        self.ckpt_times: list[tuple[int, float, float]] = []
        self._step_fn = make_train_step(
            self.model, self.sharder, microbatches=tcfg.microbatches,
            peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total_steps=tcfg.steps,
        )
        if usf is not None:
            # auto-checkpoint at the step-dispatch boundary: revokes land
            # between steps even before the end-of-step yield below, and
            # the same instrumented path no-ops when run outside a task
            self._step_fn = preemptible(self._step_fn, runtime=usf)

    # ------------------------------------------------------------------ #
    def init_state(self) -> dict:
        """Weights drawn from a ``torch.Generator`` seeded with
        ``tcfg.seed`` on the trainer's device (torch cannot draw JAX's;
        a JAX checkpoint carries them across)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_tree(gen, self.model.param_specs(), self.cfg.param_dtype,
                           self.device)
        return init_train_state(self.model, params)

    def run(self, *, resume: bool = True,
            stop_at: Optional[int] = None) -> dict:
        """``stop_at`` simulates a crash: stop early without touching the
        LR schedule (which stays keyed to tcfg.steps)."""
        tcfg = self.tcfg
        ckpt = AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep) if tcfg.ckpt_dir else None
        state = self.init_state()
        start = 0
        if resume and tcfg.ckpt_dir:
            last = latest_step(tcfg.ckpt_dir)
            if last is not None:
                state = restore_checkpoint(tcfg.ckpt_dir, last, state)
                start = int(state["step"])
        ds = SyntheticLMDataset(self.cfg, global_batch=tcfg.global_batch,
                                seq_len=tcfg.seq_len, seed=tcfg.seed)
        loader = PrefetchLoader(ds, start_step=start, usf=self.usf)
        task = self.usf.current_task() if self.usf is not None else None
        tid, job = (task.tid, task.job.name) if task is not None else (None, "trainer")
        clock = spans.clock
        try:
            for step in range(start, min(stop_at or tcfg.steps, tcfg.steps)):
                emit = spans.emit
                if emit is not None:
                    key = (job, step + 1)
                    spans.bind(tid, key)
                    t_step = clock()
                raw = loader.get()
                if emit is not None:
                    t = clock()
                    emit((t_step, t, "train.loader", tid, key, None))
                batch = to_tensors(raw, self.device)
                t0 = clock()
                if emit is not None:
                    emit((t, t0, "train.h2d", tid, key, None))
                state, metrics = self._step_fn(state, batch)
                if emit is not None:
                    t = clock()
                    emit((t0, t, "train.dispatch", tid, key, None))
                loss = float(metrics["loss"])  # sync point
                t1 = clock()
                if emit is not None:
                    emit((t, t1, "train.sync", tid, key, None))
                rec = {"step": step + 1, "loss": loss, "wall_s": t1 - t0}
                self.metrics_log.append(rec)
                try:
                    if self.on_step:
                        self.on_step(step + 1, rec)
                    if ckpt and (step + 1) % tcfg.ckpt_every == 0:
                        ckpt.save(state, step + 1)
                finally:  # a callback that ends the run still ends the step's span
                    if emit is not None:
                        emit((t_step, clock(), "train.step", tid, key, None))
                if task is not None:
                    # scheduling point between steps: lets SCHED_COOP rotate
                    # jobs at quantum boundaries (§4.1)
                    if emit is not None:
                        t = clock()
                    self.usf.yield_now()
                    if emit is not None:
                        emit((t, clock(), "train.yield", tid, key, None))
        finally:
            loader.stop()
            if ckpt:
                ckpt.wait()
                self.ckpt_times.extend(ckpt.times)
        return state
