"""A cell run with the program's spans armed and joined to the device
trace: the readings of the span metrics (``dispatch_ms.train``,
``turnaround_ms.train``, ``idle_in_dispatch_share.train``,
``engine_dispatch_ms.open``, ``engine_sync_ms.open``) beside the cell's
per-layer metrics, the breakdown with its idle gaps named by job and span
and ``idle_by_span``, the clock pairs and their drift, the share of each
task's time its top spans cover, the labels that hold the three longest
gaps, and the median span of each name in the window. With ``--compare-off`` each seed also runs with nothing armed and
no trace, in turns (armed first on even seeds' places), for the window's
training tokens a second on both sides.

The harness's own runs arm nothing yet; this script does what its
``--trace 1`` run would do with spans: the span sink armed before set-up,
the scheduler's decision recorder once the runtime exists, and a trace
that reads its clock pairs where the cell file places its trace. All seeds
run in one process.

    python3 usfbench/span_probe.py --workload <name> --seeds 11,12,13 \\
        [--seconds 51] [--compare-off] [--out build/span_probe.jsonl]
"""

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the span metrics, read in the cells where they find something
SPAN_METRICS = ["dispatch_ms.train", "turnaround_ms.train", "idle_in_dispatch_share.train",
                "engine_dispatch_ms.open", "engine_sync_ms.open"]
#: the spans that together cover a task's time
TOP_SPANS = ("train.step", "train.yield", "engine.step", "engine.idle")


def probe(workload: str, seed: int, seconds: float, device: str, armed: bool = True,
          overrides=None) -> dict:
    import torch

    from repro_torch.runtime import spans as sink
    from repro_torch.trace.recorder import TraceRecorder
    from usfbench import spantrace
    from usfbench.harness import (Context, benchmark_with, cell_metrics, load_metric, setup,
                                  stop, window)

    bench = benchmark_with(json.loads((ROOT / "BENCHMARK.json").read_text()), workload)
    ctx = Context(workload, seed=seed, seconds=seconds, trace=False, device=device,
                  bench=bench, t_proc0=time.monotonic(), overrides=overrides)
    rec = trace = None
    if armed:
        sink.arm()
    try:
        setup(ctx)
        if armed:
            rec = TraceRecorder().attach_runtime(ctx.usf)
            tr = ctx.cell["trace"]
            start = time.monotonic() + tr["start_frac"] * ctx.seconds
            trace = spantrace.ClockedTrace(start, start + tr["seconds"])
            trace.begin()
        window(ctx, log=lambda m: None)
        if trace is not None:
            trace.join(timeout=120.0)
    finally:
        sink.disarm()
        if rec is not None:
            rec.detach_all()
        if ctx.usf is not None:
            stop(ctx)
    out = {"workload": workload, "seed": seed, "armed": armed,
           "device": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
           else "cpu",
           "train_tok_s": load_metric("train_tok_s").read(ctx)}
    if not armed:
        return out
    ctx.trace, ctx.spans, ctx.records = trace, sink.spans(), rec.records()
    names = [m["name"] for m in cell_metrics(bench, workload, "per_layer")] + SPAN_METRICS
    out["metrics"] = {n: v for n in names if (v := load_metric(n).read(ctx)) is not None}
    out["busy_s"], out["window_s"] = trace.busy_s(), trace.window_s
    out["breakdown"] = spantrace.breakdown(trace, ctx.spans, ctx.records)
    out["longest_gaps"] = [[secs, {spantrace.label_name(k): v for k, v in acc.items()}]
                           for secs, _, acc in spantrace.longest_gaps(trace, ctx.spans,
                                                                      ctx.records, 3)]
    offs = trace.offsets_ns()
    out["clock"] = {"offsets_ns": offs, "drift_ns": offs[-1] - offs[0],
                    "pairs_apart_s": (trace.pairs[-1][0] - trace.pairs[0][0]) / 1e9}
    idle = spantrace.idle_by_label(trace, ctx.spans, ctx.records)
    out["idle_by_label"] = sorted(([spantrace.label_name(k), v] for k, v in idle.items()),
                                  key=lambda x: -x[1])
    job_of = {s[3]: s[4][0] for s in ctx.spans if s[3] is not None}
    out["coverage"] = {job: spantrace.coverage(ctx.spans, tid, TOP_SPANS, trace.t0, trace.t1)
                       for tid, job in job_of.items()}
    out["median_ms"] = {}
    for name in sorted({s[2] for s in ctx.spans}):
        got = spantrace.durations(ctx.spans, name, ctx.t_w0, ctx.t_w1)
        if got:
            out["median_ms"][name] = 1e3 * statistics.median(got)
    out["traced_tok_s"] = _traced_rate(ctx)
    return out


def _traced_rate(ctx):
    from usfbench.generator import overlap_rate

    steps = [iv for j in ctx.jobs_of("train") for iv in j.intervals]
    return overlap_rate(steps, ctx.trace.t0, ctx.trace.t1) if steps else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--compare-off", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        sides = [True, False] if i % 2 == 0 else [False, True]
        for armed in sides if args.compare_off else [True]:
            t = time.monotonic()
            rec = probe(args.workload, seed, args.seconds, "cuda:0", armed)
            rec["seconds"] = time.monotonic() - t
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
