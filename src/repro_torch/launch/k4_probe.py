"""K4 probes on one CUDA card, using ``chip_smoke.py``'s helpers.

    python src/repro_torch/launch/k4_probe.py timers [--src DIR] [--label L] [--shape B,S,H,P,N,Q ...]

timers  K4 (``ops.ssd_scan`` of the package under DIR, by default this
        checkout's ``src``) on the route it takes, on route fwd (the chunk
        walker, ssd_fwd) forced where DIR's package has routes, and the model's
        chunked algebra (``ssd_chunked``) at mamba2-2.7b's prefill shape
        (B=4, S=2048, H=80, P=64, N=128, Q=256, bf16 x, B and C, fp32 dt and
        A), each as device time (``chip_smoke.time_ms``: L2 flushed, the
        device spin before each call), beside the bound of each route
        (``chip_smoke.ssd_bound``: bytes against operations at the bf16
        tensor-core rate for route tc, at the fp32 rate for route fwd); the
        device time of each of K4's kernels over a few calls
        (``torch.profiler``); and the kernels' ptxas report (registers,
        shared memory, spills, wgmma serialisation) for DIR's build. To
        compare two trees, unpack the older one with ``git archive`` into
        ``build/`` and run both on one card in one go, older, newer, newer,
        older. ``--shape`` adds rows of other bf16 shapes.

It prints JSON lines; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ROWS = {"mamba2-2.7b prefill": (4, 2048, 80, 64, 128, 256)}  # B, S, H, P, N, Q


def _setup(src: str):
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("k4_probe: needs a CUDA card")
    import chip_smoke

    return chip_smoke, torch.device("cuda", 0)


def _kernel_ms(cs, fn, calls=5):
    """Device ms a call of each K4 kernel (by name), from torch.profiler
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
        if e.device_type == DeviceType.CUDA and cs.SSD_ANY in e.key:
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            found = re.search(r"ssd_\w+", e.key)
            name = found.group(0) if found else e.key
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / calls
    return out


def timers(args) -> None:
    import torch
    import torch.nn.functional as F

    cs, dev = _setup(args.src)
    from repro_torch.kernels import build, ops, ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked

    build.load("ssd_scan")
    print(json.dumps({"label": args.label, "card": cs.card(), "ptxas": [
        line.strip() for line in build.build_log("ssd_scan").splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
        or "C75" in line]}), flush=True)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = {**ROWS, **{f"shape {s}": tuple(int(v) for v in s.split(","))
                       for s in args.shape}}
    routed = hasattr(ssd_scan, "_route")
    for name, (B, S, H, P, N, Q) in rows.items():
        x = torch.randn(B, S, H, P, generator=gen, device=dev).bfloat16()
        dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
        A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
        Bm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5).bfloat16()
        Cm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5).bfloat16()
        route = ssd_scan._route(x, Bm, Cm, Q) if routed else "fwd (no _route)"
        fns = {"ms": lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)}
        if routed and route != "fwd":
            fns["fwd_ms"] = lambda: ssd_scan.launch(x, dt, A, Bm, Cm, Q, "fwd")
        row = {key: cs.time_ms(fn, flush, 20) for key, fn in fns.items()}
        row["chunked_ms"] = cs.time_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, Q), flush, 5,
                                       warmup=1)
        (bound, by), flops, moved = cs.ssd_bound(B, S, H, P, N, Q, 2)
        (bound32, by32), _, _ = cs.ssd_bound(B, S, H, P, N, Q, 2, "float32")
        print(json.dumps({
            "label": args.label, "row": name, "shape": [B, S, H, P, N, Q], "route": route,
            **row, "bound_ms": bound, "bound_by": by, "bound_ms_fwd": bound32,
            "bound_by_fwd": by32, "of_bound": bound / row["ms"],
            "fwd_of_bound": bound32 / row.get("fwd_ms", row["ms"]),
            "gflop": flops / 1e9, "mb": moved / 1e6,
            "kernel_ms": _kernel_ms(cs, fns["ms"]),
        }), flush=True)
        del x, dt, A, Bm, Cm


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("timers")
    p.add_argument("--src", default=str(ROOT / "src"))
    p.add_argument("--label", default="this checkout")
    p.add_argument("--shape", nargs="*", default=[], metavar="B,S,H,P,N,Q")
    timers(ap.parse_args())


if __name__ == "__main__":
    main()
