"""K3 probes on one CUDA card, using ``chip_smoke.py``'s helpers.

    python src/repro_torch/launch/k3_probe.py timers [--src DIR] [--label L] [--shape E,C,D,F ...]

timers  K3 (``ops.moe_gmm`` of the package under DIR, by default this
        checkout's ``src``) and ``torch.bmm`` at K3's main-path rows
        (deepseek-moe-16b's gate/up and down products at prefill and at
        served decode, and decode at 4 rows), each as device time
        (``chip_smoke.time_ms``: L2 flushed, the device spin before each
        call), beside the bound (``chip_smoke.gmm_bound``), the route that
        took the call, and the kernel's ptxas report (registers, shared
        memory, spills, wgmma serialisation) for DIR's build. To compare
        two trees, unpack the older one with ``git archive`` into
        ``build/`` and run both on one card in one go, older, newer, newer,
        older. ``--shape`` adds rows of other bf16 shapes (E,C,D,F).

It prints JSON lines; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
ROWS = {  # name: E, C, D, F
    "prefill wg": (64, 964, 2048, 1408),
    "prefill wd": (64, 964, 1408, 2048),
    "decode wg": (64, 16, 2048, 1408),
    "decode wd": (64, 16, 1408, 2048),
    "decode wg C4": (64, 4, 2048, 1408),
}


def _setup(src: str):
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("k3_probe: needs a CUDA card")
    import chip_smoke

    return chip_smoke, torch.device("cuda", 0)


def _route(x, w) -> str:
    from repro_torch.kernels import moe_gmm

    route = getattr(moe_gmm, "_route", None)
    return "mma (no _route)" if route is None else route(x, w)


def timers(args) -> None:
    import torch

    cs, dev = _setup(args.src)
    from repro_torch.kernels import build, ops

    build.load("moe_gmm")
    print(json.dumps({"label": args.label, "card": cs.card(), "ptxas": [
        line.strip() for line in build.build_log("moe_gmm").splitlines()
        if "registers" in line or "spill" in line or "Compiling entry" in line
        or "C75" in line]}), flush=True)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = {**ROWS, **{f"shape {s}": tuple(int(v) for v in s.split(","))
                       for s in args.shape}}
    for name, (E, C, D, F) in rows.items():
        x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
        w = (torch.randn(E, D, F, generator=gen, device=dev) / D ** 0.5).bfloat16()
        ms = cs.time_ms(lambda: ops.moe_gmm(x, w), flush)
        bmm = cs.time_ms(lambda: torch.bmm(x, w), flush)
        bound, by = cs.gmm_bound(E, C, D, F)
        print(json.dumps({"label": args.label, "row": name, "shape": [E, C, D, F],
                          "route": _route(x, w), "ms": ms, "bmm_ms": bmm,
                          "bound_ms": bound, "bound_by": by, "of_bound": bound / ms,
                          "vs_bmm": ms / bmm}), flush=True)
        del x, w


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("timers")
    p.add_argument("--src", default=str(ROOT / "src"))
    p.add_argument("--label", default="this checkout")
    p.add_argument("--shape", nargs="*", default=[], metavar="E,C,D,F")
    timers(ap.parse_args())


if __name__ == "__main__":
    main()
