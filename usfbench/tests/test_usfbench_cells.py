"""Each cell rehearsed at smoke size on the CPU through the whole harness
(set-up, window, drain, check against the plain reference, metrics), and
the faults a cell can have, planted in the timed path underneath, each of
which must turn ``correct`` false."""

import pytest
import torch

import repro_torch.serve.engine as engine
import repro_torch.train.trainer as trainer_mod
from usfbench.reference.dense import flat
from usfbench_smoke import bench, smoke_run

torch.set_num_threads(min(2, torch.get_num_threads()))

CELLS = [w["name"] for w in bench()["workloads"]]
SERVE_CELLS = [w["name"] for w in bench()["workloads"] if w["traffic"] != "train-pair"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearsal_is_correct(workload):
    ctx, out = smoke_run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    want = {m["name"] for m in bench()["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    for j in ctx.jobs_of("train"):
        assert len(j.intervals) >= 3


@pytest.mark.parametrize("workload", CELLS)
def test_per_layer_metrics_without_a_trace(workload):
    """The counter and host-clock readers read a smoke run; the trace
    readers find nothing and return nothing (never 0)."""
    from usfbench.harness import cell_metrics, load_metric

    ctx, _ = smoke_run(workload)
    for m in cell_metrics(bench(), workload, "per_layer"):
        v = load_metric(m["name"]).read(ctx)
        if m["source"] == "device_trace":
            assert v is None
        else:
            assert v is not None and v >= 0, m["name"]


def _train_fault(monkeypatch, fault):
    real = trainer_mod.make_train_step

    def make(model, sharder, **kw):
        step = real(model, sharder, **kw)

        def faulty(state, batch):
            if fault == "unchanged":
                keep = {k: v.detach().clone() for k, v in flat(state).items()
                        if isinstance(v, torch.Tensor)}
                new, metrics = step(state, batch)
                with torch.no_grad():
                    for k, v in flat(state).items():
                        v.copy_(keep[k])
                return state, metrics
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)

        return faulty

    monkeypatch.setattr(trainer_mod, "make_train_step", make)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_caught(monkeypatch, workload, fault):
    _train_fault(monkeypatch, fault)
    _, out = smoke_run(workload)
    assert not out["correct"], out["checks"]


def _serve_fault(monkeypatch, fault):
    real = engine.make_serve_step

    def make(model, sharder):
        step = real(model, sharder)

        def faulty(params, cache, tokens, positions):
            if fault == "unchanged":
                keep = {k: v.clone() for k, v in flat(cache).items()}
                logits, _ = step(params, cache, tokens, positions)
                for k, v in flat(cache).items():
                    v.copy_(keep[k])
                return logits, cache
            logits, cache = step(params, cache, tokens, positions)
            logits = logits.clone()
            logits[:, 7] = logits.max() + 1.0  # the served token, altered
            return logits, cache

        return faulty

    monkeypatch.setattr(engine, "make_serve_step", make)


@pytest.mark.parametrize("workload", SERVE_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "token_altered"])
def test_serving_fault_is_caught(monkeypatch, workload, fault):
    _serve_fault(monkeypatch, fault)
    _, out = smoke_run(workload)
    assert not out["correct"], out["checks"]
    assert out["checks"]["serve_gap"]["value"] > out["checks"]["serve_gap"]["limit"]


def test_serving_cell_file_holds_its_whole_entry():
    """The serving cell, not in BENCHMARK.json yet, brings from its own file
    every entry it would add: its workload, and each metric it reports,
    read by a reader file and moving one of its end-to-end metrics."""
    from usfbench.harness import HERE

    b = bench()
    assert SERVE_CELLS == ["smollm-360m.serve-with-train"]
    (name,) = SERVE_CELLS
    e2e = {m["name"] for m in b["end_to_end"] if name in m.get("workloads", [name])}
    layer = [m for m in b["per_layer"] if name in m.get("workloads", [name])]
    assert e2e == {"req_p75_s", "train_tok_s", "setup_s"}
    for m in layer:
        assert m["moves"] in e2e and (HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("script", ["sweep", "control"])
def test_serving_cell_scripts_run_from_its_file(script):
    """The knee sweep and the control readings run the serving cell from
    its cell file (smoke size)."""
    from usfbench_smoke import SERVE_CELL, smoke_overrides

    over = smoke_overrides(SERVE_CELL)
    if script == "sweep":
        from usfbench.sweep import sweep

        rows = sweep(SERVE_CELL, 7, [4.0], 2.0, "cpu", overrides=over)
        assert rows[0]["due"] > 0 and rows[0]["unanswered"] == 0
    else:
        from usfbench.control import readings

        rec = readings(SERVE_CELL, 7, 2.0, True, "cpu", overrides=over)
        assert rec["program"] and rec["control"] and rec["half_batch"]
