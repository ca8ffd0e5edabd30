"""Job kind "train": the port's ``Trainer`` (its train step with
microbatches and remat, AdamW, the prefetching loader) as a USF task, on
weights the benchmark draws from the seed. It starts in set-up, runs its
first steps there, and runs on through the window until the harness stops
it after the drain.

Its check follows the first three steps, which ran through the trainer's
own call and feed: each step's loss, each leaf's first gradient as AdamW
got it (its first moment after one step over 1 - b1), and each leaf's
change over the three steps, read before step 4 writes them; the plain
reference takes the same steps from the same weights and batches."""

from __future__ import annotations

import statistics
import threading
import time

from usfbench.reference.data import batch_at
from usfbench.reference.dense import AdamW, flat
from usfbench.reference.train import first_steps

#: the steps whose results the check compares
CHECKED_STEPS = 3


class _Stop(Exception):
    """Raised from the step callback to end the trainer's run."""


class Job:
    kind = "train"

    def __init__(self, ctx, spec: dict, index: int):
        self.ctx = ctx
        self.spec = spec
        self.index = index
        self.name = f"trainer{index}"
        self.seed = ctx.seed_for("train", index)
        self.data_seed = ctx.seed_for("data", index)
        self.tokens_per_step = spec["global_batch"] * spec["seq_len"]
        #: (start, end, tokens) of every step, host monotonic seconds
        self.intervals: list[tuple[float, float, int]] = []
        self.readings: dict = {}
        self.trainer = None
        self.task = None
        self._p0 = None
        self._state = None
        self._checked = threading.Event()

    def build(self, usf) -> None:
        import numpy as np

        from repro_torch.data.pipeline import SyntheticLMDataset
        from repro_torch.train.step import init_train_state
        from repro_torch.train.trainer import Trainer, TrainerConfig

        ctx, spec = self.ctx, self.spec
        tcfg = TrainerConfig(
            steps=spec["schedule_steps"], global_batch=spec["global_batch"],
            seq_len=spec["seq_len"], microbatches=spec["microbatches"],
            peak_lr=spec["peak_lr"], warmup=spec["warmup"], ckpt_dir=None,
            seed=self.data_seed)
        ds = SyntheticLMDataset(ctx.arch, global_batch=tcfg.global_batch,
                                seq_len=tcfg.seq_len, seed=tcfg.seed)
        for s in range(CHECKED_STEPS):  # the feed is the reference's
            want = self.batch(s)
            got = ds.batch_at(s)
            if not all(np.array_equal(got[k], want[k]) for k in want):
                raise RuntimeError("the trainer's batches differ from the benchmark's")
        job = self
        params = ctx.make_params(self.seed)

        class BenchTrainer(Trainer):
            def init_state(self) -> dict:
                state = init_train_state(self.model, params)
                job._state = state
                job._p0 = {k: v.detach().clone() for k, v in flat(state["params"]).items()}
                return state

        self.trainer = BenchTrainer(ctx.arch, tcfg, usf=usf, device=ctx.device,
                                    on_step=self._on_step)
        self._usf = usf

    def batch(self, step: int) -> dict:
        return batch_at(self.data_seed, step, batch=self.spec["global_batch"],
                        seq_len=self.spec["seq_len"], vocab=self.ctx.conf["vocab_size"])

    def _on_step(self, step: int, rec: dict) -> None:
        now = time.monotonic()
        self.intervals.append((now - rec["wall_s"], now, self.tokens_per_step))
        if step == 1:
            b1 = AdamW().b1
            self.readings["grad_norms"] = {
                k: float(v.double().norm()) / (1 - b1)
                for k, v in flat(self._state["opt"]["m"]).items()}
        if step == CHECKED_STEPS:
            p = flat(self._state["params"])
            self.readings["delta_norms"] = {
                k: float((p[k].detach().double() - v.double()).norm())
                for k, v in self._p0.items()}
            self.readings["losses"] = [m["loss"] for m in self.trainer.metrics_log[:step]]
            self._p0 = None
            self._checked.set()
        if self.ctx.stop_training.is_set():
            raise _Stop

    def start(self) -> None:
        from repro_torch.core.policies import SchedCoop
        from repro_torch.core.task import Job as UsfJob

        def body():
            try:
                self.trainer.run(resume=False)
            except _Stop:
                pass

        job = UsfJob(self.name)
        if "share" in self.spec:  # a lease of its own, as the servers have
            self._usf.attach(job, policy=SchedCoop(), share=self.spec["share"])
        self.task = self._usf.create(body, job=job, name=self.name)

    def ready(self) -> bool:
        if self.task is not None and getattr(self.task, "_exc", None) is not None:
            raise RuntimeError(f"{self.name} failed:\n{self.task._exc}")
        return self._checked.is_set()

    def tasks(self) -> list:
        return [self.task]

    def counters(self) -> dict:
        return {"steps": len(self.intervals)}

    def stop(self) -> None:
        pass  # the harness sets ctx.stop_training and joins the task

    def free(self) -> None:
        self.trainer = None
        self._state = None

    # ------------------------------------------------------------------ #
    def reference(self, ctx, **kw) -> dict:
        """The reference's first steps from the seed's weights and batches
        (``quant``: the control; ``rows``: a planted fault)."""
        spec = self.spec
        return first_steps(ctx.conf, ctx.make_params(self.seed),
                           [self.batch(s) for s in range(CHECKED_STEPS)],
                           peak_lr=spec["peak_lr"], warmup=spec["warmup"],
                           total=spec["schedule_steps"], device=ctx.device, **kw)

    def check(self, ctx, readings=None) -> dict:
        """The numbers compared; ``readings`` in the place of the program's
        (the control, a planted fault)."""
        return compare(self.readings if readings is None else readings,
                       self.reference(ctx))


def compare(got: dict, ref: dict) -> dict:
    """loss_gap: the widest gap of a checked step's loss (nats). grad_gap
    and update_gap: the worst leaf's gap between the two norms of its first
    gradient and of its change over the checked steps, over the reference's
    norm of that leaf or of the median leaf, whichever is larger. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by rounding alone and are left out of the change."""
    gr, dr = ref["grad_norms"], ref["delta_norms"]
    g_med = statistics.median(gr.values())
    moving = [k for k in dr if gr[k] >= 1e-3 * g_med]
    d_med = statistics.median(dr[k] for k in moving)
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": max(abs(got["grad_norms"][k] - gr[k]) / max(gr[k], g_med) for k in gr),
        "update_gap": max(abs(got["delta_norms"][k] - dr[k]) / max(dr[k], d_med)
                          for k in moving),
    }
