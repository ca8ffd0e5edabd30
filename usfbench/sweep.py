"""The knee of an open-loop cell: one set-up, then a window at each rate
in turn, each drained before the next. For each rate it prints the
requests due, those answered by the window's close, those still in flight
then, the latency median and 95th percentile, the servers' engine steps a
second and the training tokens a second. The knee is the highest rate at
which the backlog does not grow: what is in flight at the close stays
near what one mean latency at that rate holds, and latency does not climb
with the window.

    python3 usfbench/sweep.py --workload <name> --seed <n> --rates 2,4,6 \\
        --seconds 20 [--out build/sweep.jsonl]
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sweep(workload: str, seed: int, rates: list[float], seconds: float, device: str,
          overrides=None, out=None) -> list[dict]:
    from usfbench.generator import overlap_rate, percentile
    from usfbench.harness import Context, benchmark_with, setup, stop, window

    bench = benchmark_with(json.loads((ROOT / "BENCHMARK.json").read_text()), workload)
    ctx = Context(workload, seed=seed, seconds=seconds, trace=False, device=device,
                  bench=bench, t_proc0=time.monotonic(), overrides=overrides)
    rows = []
    setup(ctx)
    try:
        for rate in rates:
            ctx.traffic.cell["rate_per_s"] = rate
            window(ctx, log=lambda m: None)
            due = ctx.traffic.due_in(ctx.t_w0, ctx.t_w1)
            lat = [s.latency for s in due if s.latency is not None]
            half = ctx.t_w0 + ctx.window_s / 2
            in_flight = lambda t: sum(1 for s in due if s.due < t and  # noqa: E731
                                      (s.done_at is None or s.done_at > t))
            steps = [ctx.edge_delta(j, "steps") for j in ctx.jobs_of("serve")]
            train = [iv for j in ctx.jobs_of("train") for iv in j.intervals]
            row = {"rate_per_s": rate, "due": len(due),
                   "answered_by_close": sum(1 for s in due if s.done_at and s.done_at <= ctx.t_w1),
                   "in_flight_mid": in_flight(half), "in_flight_close": in_flight(ctx.t_w1),
                   "unanswered": sum(1 for s in due if s.done_at is None),
                   "latency_p50_s": statistics.median(lat) if lat else None,
                   "latency_p75_s": percentile(lat, 75) if lat else None,
                   "latency_p95_s": percentile(lat, 95) if lat else None,
                   "engine_steps_per_s": [s / ctx.window_s for s in steps],
                   "train_tok_s": overlap_rate(train, ctx.t_w0, ctx.t_w1) if train else None}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    finally:
        stop(ctx)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    sweep(args.workload, args.seed, [float(r) for r in args.rates.split(",")],
          args.seconds, "cuda:0", out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
