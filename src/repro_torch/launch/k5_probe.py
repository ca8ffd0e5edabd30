"""K5 probes on one CUDA card, using ``chip_smoke.py``'s helpers.

    python src/repro_torch/launch/k5_probe.py timers [--src DIR] [--label L] [--shape B,S,W ...]

timers  K5 of the package under DIR (by default this checkout's ``src``) at
        recurrentgemma-9b's prefill shape (B=4, S=2048, W=4096), as device
        time (``chip_smoke.time_ms``: L2 flushed, the device spin before
        each call): the first entry (``ops.rglru``) in fp32 and in bf16 on
        the route it takes and on route fwd (rglru_fwd) forced where
        DIR's package has routes, beside its bound (``chip_smoke.
        rglru_bound``); the gated entry (``ops.rglru_gated``) in bf16 beside
        its bound, and the model's unfused sequence (the gate math in eager
        fp32 ops, h0 folded into the first step, the first entry from zeros,
        y cast to bf16) on the first entry's route and on route fwd; each
        K5 kernel's device time over a few calls (``torch.profiler``); and
        the ptxas report (registers, shared memory, spills) of DIR's build.
        A tree without routes (whose one kernel is rglru_fwd)
        times its first entry only. To compare two trees, unpack the older
        one with ``git archive`` into ``build/`` and run both on one card in
        one go, older, newer, newer, older. ``--shape`` adds rows.

It prints JSON lines; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ROWS = {"recurrentgemma-9b prefill": (4, 2048, 4096)}  # B, S, W


def _setup(src: str):
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("k5_probe: needs a CUDA card")
    import chip_smoke

    return chip_smoke, torch.device("cuda", 0)


def _kernel_ms(fn, calls=5):
    """Device ms a call of each K5 kernel (by name), from torch.profiler
    over ``calls`` calls after a warm-up one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "rglru_" in e.key:
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            found = re.search(r"rglru_\w+", e.key)
            name = found.group(0) if found else e.key
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / calls
    return out


def timers(args) -> None:
    import torch

    cs, dev = _setup(args.src)
    from repro_torch.kernels import build, ops, rglru_scan

    build.load("rglru_scan")
    print(json.dumps({"label": args.label, "card": cs.card(), "ptxas": [
        line.strip() for line in build.build_log("rglru_scan").splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
        or "C75" in line]}), flush=True)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    rows = {**ROWS, **{f"shape {s}": tuple(int(v) for v in s.split(","))
                       for s in args.shape}}
    routed = hasattr(rglru_scan, "_route")
    for name, (B, S, W) in rows.items():
        for dtype in (torch.float32, torch.bfloat16):
            a, b, h0 = (t.contiguous() for t in cs.rglru_inputs(gen, dev, dtype, B, S, W))
            route = rglru_scan._route(a, b) if routed else "fwd (no _route)"
            fns = {"ms": lambda: ops.rglru(a, b, h0)}
            if routed and route != "fwd":
                fns["fwd_ms"] = lambda: rglru_scan.launch(a, b, h0, "fwd")
            row = {key: cs.time_ms(fn, flush) for key, fn in fns.items()}
            (bound, by), moved = cs.rglru_bound(B, S, W, a.element_size())
            print(json.dumps({
                "label": args.label, "row": name, "entry": "first", "dtype": str(dtype),
                "shape": [B, S, W], "route": route, **row, "bound_ms": bound,
                "bound_by": by, "mb": moved / 1e6, "of_bound": bound / row["ms"],
                "fwd_of_bound": bound / row.get("fwd_ms", row["ms"]),
                "kernel_ms": _kernel_ms(fns["ms"]),
            }), flush=True)
            del a, b, h0
        if not routed:
            continue
        r, i, x, lab, h0 = (t.contiguous() for t in cs.gated_inputs(
            gen, dev, torch.bfloat16, B, S, W))
        fns = {"ms": lambda: ops.rglru_gated(r, i, x, lab, h0),
               "unfused_ms": lambda: cs.unfused_gated(r, i, x, lab, h0, "ring"),
               "unfused_fwd_ms": lambda: cs.unfused_gated(r, i, x, lab, h0)}
        row = {key: cs.time_ms(fn, flush, 50 if key == "ms" else 20)
               for key, fn in fns.items()}
        (bound, by), moved = cs.rglru_bound(B, S, W, 2, gated=True)
        print(json.dumps({
            "label": args.label, "row": name, "entry": "gated", "dtype": "torch.bfloat16",
            "shape": [B, S, W], **row, "bound_ms": bound, "bound_by": by,
            "mb": moved / 1e6, "of_bound": bound / row["ms"],
            "kernel_ms": _kernel_ms(fns["ms"]),
        }), flush=True)
        del r, i, x, lab, h0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("timers")
    p.add_argument("--src", default=str(ROOT / "src"))
    p.add_argument("--label", default="this checkout")
    p.add_argument("--shape", nargs="*", default=[], metavar="B,S,W")
    timers(ap.parse_args())


if __name__ == "__main__":
    main()
