"""The port's spans (``repro_torch.runtime.spans``): a disarmed sink costs
a trainer step no clock read and no tuple beyond the step's own timing; an
armed one records the trainer's and the engine's spans nested in order,
under the USF task that ran them."""

import pytest
import torch

from repro_torch.configs.base import get_smoke
from repro_torch.core.policies import SchedCoop
from repro_torch.core.scheduler import REC_DISPATCH
from repro_torch.core.task import Job
from repro_torch.core.threads import UsfRuntime
from repro_torch.core.topology import Topology
from repro_torch.runtime import spans
from repro_torch.serve.engine import InferenceServer, Request
from repro_torch.trace.recorder import TraceRecorder
from repro_torch.train.trainer import Trainer, TrainerConfig

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture
def sink():
    spans.arm()
    try:
        yield spans
    finally:
        spans.disarm()


def _train_on_usf(steps: int, microbatches: int):
    """A smoke Trainer run as a USF task of job "trainer0" on one slot,
    with the decision recorder armed: (trainer, task, records)."""
    usf = UsfRuntime(Topology(1, 1), SchedCoop(quantum=0.05))
    rec = TraceRecorder().attach_runtime(usf)
    trainer = Trainer(get_smoke("smollm_360m"), TrainerConfig(
        steps=steps, global_batch=4, seq_len=32, microbatches=microbatches,
        ckpt_dir=None, peak_lr=1e-3, warmup=2), usf=usf, device="cpu")
    try:
        task = usf.create(lambda: trainer.run(resume=False), job=Job("trainer0"),
                          name="trainer0")
        assert usf.join(task, timeout=120.0), "trainer timed out"
    finally:
        usf.shutdown(timeout=5.0)
        rec.close()
    return trainer, task, rec.records()


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_disarmed_sink_reads_no_clock_and_binds_nothing(monkeypatch):
    """Disarmed, a step reads the clock only for its own ``wall_s`` (twice)
    and never binds a key; nothing is recorded."""
    reads = []

    def clock():
        reads.append(1)
        return float(len(reads))

    def bind(tid, key):
        raise AssertionError("a disarmed step bound a key")

    spans.disarm()
    monkeypatch.setattr(spans, "clock", clock)
    monkeypatch.setattr(spans, "bind", bind)
    before = spans.spans()
    trainer, _, _ = _train_on_usf(steps=2, microbatches=2)
    assert len(trainer.metrics_log) == 2
    assert len(reads) == 2 * 2
    assert spans.spans() == before
    assert spans.emit is None


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_spans_nest_in_order_on_its_task(sink, microbatches):
    trainer, task, records = _train_on_usf(steps=2, microbatches=microbatches)
    got = sink.spans()
    assert {s[3] for s in got} == {task.tid}
    assert task.tid in {r[2] for r in records if r[1] == REC_DISPATCH}
    for step in (1, 2):
        mine = [s for s in got if s[4] == ("trainer0", step)]
        names = [s[2] for s in mine]
        assert names == (["train.loader", "train.h2d"]
                         + ["train.fwd_bwd"] * microbatches
                         + ["train.optimizer", "train.dispatch", "train.sync",
                            "train.step", "train.yield"])
        by = {s[2]: s for s in mine}
        outer = by["train.step"]
        loader, h2d, dispatch, sync = (by[n] for n in ("train.loader", "train.h2d",
                                                       "train.dispatch", "train.sync"))
        # the four children follow each other inside the step
        assert outer[0] == loader[0] and loader[1] == h2d[0]
        assert h2d[1] == dispatch[0] and dispatch[1] == sync[0] and sync[1] <= outer[1]
        fwd = [s for s in mine if s[2] == "train.fwd_bwd"]
        assert [s[5] for s in fwd] == list(range(microbatches))
        for s in fwd + [by["train.optimizer"]]:
            assert _inside(s, dispatch)
        assert by["train.yield"][0] >= outer[1]
        # the step's wall time is the dispatch and the sync, as before the spans
        assert trainer.metrics_log[step - 1]["wall_s"] == sync[1] - dispatch[0]


@pytest.mark.parametrize("prompts", [[[5, 6, 7]], [[5, 6, 7], [8, 9]]])
def test_engine_step_spans_hold_admit_dispatch_sync(sink, prompts):
    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        server = InferenceServer("srv", get_smoke("smollm_360m"), usf, max_batch=2,
                                 max_len=32, device="cpu")
        server.start()
        reqs = [server.submit(Request(tokens=list(p), max_new=2 + i))
                for i, p in enumerate(prompts)]

        def client():
            for r in reqs:
                r.done.wait()

        t = usf.create(client, job=Job("client"), name="client")
        assert usf.join(t, timeout=120.0), "client timed out"
        server.stop()
        assert usf.join(server._task, timeout=60.0)
    finally:
        usf.shutdown(timeout=5.0)
    got = sink.spans()
    assert {s[3] for s in got} == {server._task.tid}
    steps = [s for s in got if s[2] == "engine.step"]
    assert [s[4] for s in steps] == [("srv", i) for i in range(server.steps)]
    for outer in steps:
        kids = [s for s in got if s[4] == outer[4] and s[2] != "engine.step"
                and s[2] != "engine.idle"]
        assert [s[2] for s in kids] == ["engine.admit", "engine.dispatch", "engine.sync"]
        assert kids[0][0] == outer[0] and kids[2][1] <= outer[1]
        assert kids[0][1] == kids[1][0] and kids[1][1] == kids[2][0]
    # a request holds a slot for its prompt's teacher-forced steps and its outputs
    assert sum(s[5] for s in steps) == sum(len(r.tokens) - 1 + r.max_new for r in reqs)
    assert steps[0][5] >= 1 and max(s[5] for s in steps) <= len(prompts)
    idle = [s for s in got if s[2] == "engine.idle"]
    assert idle and all(not (s[0] < o[1] and o[0] < s[1]) for s in idle for o in steps)


def test_a_step_that_the_callback_ends_keeps_its_span(sink):
    """A run stopped from ``on_step`` (as a benchmark stops its trainers)
    still records the step it stopped in."""

    class Stop(Exception):
        pass

    def on_step(step, rec):
        if step == 2:
            raise Stop

    trainer = Trainer(get_smoke("smollm_360m"), TrainerConfig(
        steps=5, global_batch=4, seq_len=32, ckpt_dir=None), on_step=on_step, device="cpu")
    with pytest.raises(Stop):
        trainer.run(resume=False)
    steps = [s for s in sink.spans() if s[2] == "train.step"]
    assert [s[4] for s in steps] == [("trainer", 1), ("trainer", 2)]
    assert all(s[3] is None for s in sink.spans())
