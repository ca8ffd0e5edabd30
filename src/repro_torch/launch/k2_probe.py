"""K2 probes on one CUDA card, using ``chip_smoke.py``'s helpers.

    python src/repro_torch/launch/k2_probe.py timers [--src DIR] [--label L]

timers  K2 (``ops.flash_attention`` of the package under DIR, by default
        this checkout's ``src``) and ``scaled_dot_product_attention`` at
        K2's main-path rows, each as device time (``chip_smoke.time_ms``:
        L2 flushed, the device spin before each call), beside the bound
        (``chip_smoke.flash_bound``), and the kernel's ptxas report
        (registers, shared memory, spills) for DIR's build. To compare two
        trees, unpack the older one with ``git archive`` into ``build/``
        and run both on one card in one go, older, newer, newer, older.

It prints JSON lines; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ROWS = {  # name: B, S, H, KV, D, causal, window
    "smollm-360m prefill": (4, 2048, 15, 5, 64, True, None),
    "hubert-xlarge": (4, 1024, 16, 16, 80, False, None),
    "deepseek-moe-16b prefill": (4, 2048, 16, 16, 128, True, None),
    "recurrentgemma-9b": (4, 2048, 16, 1, 256, True, 2048),
    "long row": (1, 32768, 15, 5, 64, True, None),
}


def _setup(src: str):
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("k2_probe: needs a CUDA card")
    import chip_smoke

    return chip_smoke, torch.device("cuda", 0)


def _route(q, k, v) -> str:
    from repro_torch.kernels import flash_attention

    route = getattr(flash_attention, "_route", None)
    if route is None:
        return "mma (no _route)"
    return route(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def timers(args) -> None:
    import torch
    import torch.nn.functional as F

    cs, dev = _setup(args.src)
    from repro_torch.kernels import build, ops

    build.load("flash_attention")
    print(json.dumps({"label": args.label, "card": cs.card(), "ptxas": [
        line.strip() for line in build.build_log("flash_attention").splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line]}),
        flush=True)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    for name, (B, S, H, KV, D, causal, window) in ROWS.items():
        q, k, v = cs.flash_inputs(gen, dev, torch.bfloat16, B, S, S, H, KV, D)
        iters = 5 if S > 8192 else 20
        ms = cs.time_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    window=window), flush, iters)
        qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qT, kT, vT, is_causal=causal, enable_gqa=True), flush, iters)
        bound, by = cs.flash_bound(B, S, H, KV, D, causal, window, "bfloat16")
        print(json.dumps({"label": args.label, "row": name, "route": _route(q, k, v),
                          "ms": ms, "sdpa_ms": sdpa, "bound_ms": bound,
                          "bound_by": by, "of_bound": bound / ms}), flush=True)
        del q, k, v, qT, kT, vT


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("timers")
    p.add_argument("--src", default=str(ROOT / "src"))
    p.add_argument("--label", default="this checkout")
    timers(ap.parse_args())


if __name__ == "__main__":
    main()
