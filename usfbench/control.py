"""Readings that set a cell's limits: the program's numbers over many
seeds, and over the first few the control's (the plain reference with its
products in float8, in the program's place) and a planted fault's (the
training reference on half of each batch, its mean taken over the rest).
All seeds run in one process, each a whole run of the cell at its own
sizes with a short window; the harness's own runs do not run this.

    python3 usfbench/control.py --workload <name> --seeds 11,12,... \\
        --control-seeds 3 --seconds 10 [--out build/control.jsonl]
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, seconds: float, control: bool, device: str,
             overrides=None) -> dict:
    import torch

    from usfbench.harness import Context, benchmark_with, load_metric, setup, stop, window
    from usfbench.jobs.train import compare
    from usfbench.reference.dense import fp8_quant

    bench = benchmark_with(json.loads((ROOT / "BENCHMARK.json").read_text()), workload)
    ctx = Context(workload, seed=seed, seconds=seconds, trace=False, device=device,
                  bench=bench, t_proc0=time.monotonic(), overrides=overrides)
    setup(ctx)
    window(ctx, log=lambda m: None)
    stop(ctx)
    rec: dict = {"workload": workload, "seed": seed, "program": {}, "control": {},
                 "half_batch": {}}
    for m in ("req_p75_s", "train_tok_s"):
        v = load_metric(m).read(ctx)
        if v is not None:
            rec[m] = v
    for j in ctx.jobs:
        if j.kind == "serve":
            rec["program"][f"{j.name}.serve_gap"] = j.check(ctx)["serve_gap"]
            rec[f"{j.name}.sample"] = j.sampled
            if control:
                rec["control"][f"{j.name}.serve_gap"] = j.check(ctx, quant=fp8_quant)["serve_gap"]
        else:
            ref = j.reference(ctx)
            for k, v in compare(j.readings, ref).items():
                rec["program"][f"{j.name}.{k}"] = v
            if control:
                for k, v in compare(j.reference(ctx, quant=fp8_quant), ref).items():
                    rec["control"][f"{j.name}.{k}"] = v
                half = range(j.spec["global_batch"] // 2)
                for k, v in compare(j.reference(ctx, rows=half), ref).items():
                    rec["half_batch"][f"{j.name}.{k}"] = v
    del ctx
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t = time.monotonic()
        rec = readings(args.workload, seed, args.seconds, i < args.control_seeds, "cuda:0")
        rec["seconds"] = time.monotonic() - t
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
