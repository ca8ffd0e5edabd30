"""K1 probes on one CUDA card, using ``chip_smoke.py``'s helpers.

    python src/repro_torch/launch/k1_probe.py timers [--src DIR] [--label L]
    python src/repro_torch/launch/k1_probe.py witness --out FILE
    python src/repro_torch/launch/k1_probe.py replay FILE [--src DIR] [--label L]

timers   K1 (``ops.flash_decode`` of the package under DIR, by default this
         checkout's ``src``), ``scaled_dot_product_attention`` and the plain
         version at K1's four main-path shapes (``chip_smoke.time_decode_shape``):
         each timed with the device spin of ``chip_smoke.time_ms`` (device
         time) and without it (the host's enqueue shows where it is the
         longer), and the wrapper's host time a call. To compare two trees,
         unpack the older one with ``git archive`` and run both on one card
         in one go, older, newer, newer, older.
witness  serves full-width recurrentgemma-9b in bf16 on the weights its
         specs draw (seed 0, as ``chip_smoke.py`` phase 10 does) through
         ``chip_smoke.phase_serve``, holds every K1 call against the plain
         version (``chip_smoke.k1_limit``), saves the inputs of the call that
         exceeds the limit most to FILE, and on them compares the kernel and
         the plain version in fp32 with the same function in fp64.
replay   runs ``ops.flash_decode`` of DIR's package on FILE's inputs and
         compares it with the plain version in fp32 and in fp64.

Each prints JSON lines; run from the repository root.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
SHAPES = {  # name: B, H, KV, W, D
    "serve W512 (smollm-360m)": (4, 15, 5, 512, 64),
    "long W32768": (4, 15, 5, 32768, 64),
    "recurrentgemma ring W128": (4, 16, 1, 128, 256),
    "recurrentgemma ring W2048": (4, 16, 1, 2048, 256),
}


def _setup(src: str):
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: needs a CUDA card")
    import chip_smoke

    return chip_smoke, torch.device("cuda", 0)


def timers(args) -> None:
    import torch

    cs, dev = _setup(args.src)
    print(json.dumps({"label": args.label, "card": cs.card()}), flush=True)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    for name, (B, H, KV, W, D) in SHAPES.items():
        row = cs.time_decode_shape(dev, flush, B, H, KV, W, D)
        print(json.dumps({"label": args.label, "row": name, **row}), flush=True)


def plain_in(q, k, v, cpos, qp, window, dtype):
    """The plain version's function, every step in ``dtype`` (model
    layout); the output unrounded."""
    import torch

    B, H, D = q.shape
    KV = k.shape[2]
    s = torch.einsum("bkgd,bwkd->bkgw",
                     q.to(dtype).reshape(B, KV, H // KV, D) * D ** -0.5, k.to(dtype))
    valid = (cpos >= 0) & (cpos <= qp[:, None])
    if window is not None:
        valid &= qp[:, None] - cpos < window
    valid = valid[:, None, None, :]
    p = torch.where(valid, torch.softmax(torch.where(valid, s, -1e30), dim=-1), 0.0)
    return torch.einsum("bkgw,bwkd->bkgd", p, v.to(dtype)).reshape(B, H, D), s


def compare(cs, label, got, inputs) -> None:
    """``got`` (a K1 output on ``inputs``) against the plain version's
    bf16 output, its fp32 and the fp64 function; the plain version's own
    fp32 error; and the scores around the worst element."""
    import torch

    q, k, v, cpos, qp, window = inputs
    want = cs.plain_decode(q, k, v, cpos, qp, window=window).float()
    p32, s32 = plain_in(q, k, v, cpos, qp, window, torch.float32)
    p64, s64 = plain_in(q, k, v, cpos, qp, window, torch.float64)
    got = got.float()
    excess = (got - want).abs() - cs.k1_limit(want)
    i = int(excess.argmax())
    b, h, d = (i // (q.shape[1] * q.shape[2]), (i // q.shape[2]) % q.shape[1],
               i % q.shape[2])
    G = q.shape[1] // k.shape[2]
    row64 = s64[b, h // G, h % G]
    top = torch.topk(row64, 3).values.tolist()
    print(json.dumps({
        "label": label,
        "kernel_vs_plain_bf16": (got - want).abs().max().item(),
        "kernel_excess_over_limit": excess.max().item(),
        "kernel_vs_fp64": (got.double() - p64).abs().max().item(),
        "plain_bf16_vs_fp64": (want.double() - p64).abs().max().item(),
        "plain_fp32_vs_fp64": (p32.double() - p64).abs().max().item(),
        "fp64_rounded_to_bf16_vs_plain_bf16":
            (p64.to(torch.bfloat16).float() - want).abs().max().item(),
        "scores_fp32_vs_fp64": (s32.double() - s64).abs().max().item(),
        "worst_element": {"b": b, "h": h, "d": d, "kernel": got[b, h, d].item(),
                          "plain_bf16": want[b, h, d].item(),
                          "plain_fp32": p32[b, h, d].item(),
                          "fp64": p64[b, h, d].item(),
                          "top3_scores_fp64": top,
                          "gap_top2": top[0] - top[1],
                          "max_abs_v": v[b, :, h // G].float().abs().max().item()},
    }), flush=True)


def witness(args) -> None:
    import torch

    cs, dev = _setup(args.src)
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.base import init_tree
    from repro_torch.models.registry import build_model

    cfg = get_arch("recurrentgemma_9b")
    model = build_model(cfg)
    params = model.compute_params(init_tree(
        torch.Generator(device=dev).manual_seed(0), model.param_specs(),
        cfg.compute_dtype, dev))
    kernel = ops.flash_decode
    seen = {"calls": 0, "over": 0, "excess": float("-inf")}

    def checked(q, k, v, cpos, qpos, *, window=None):
        out = kernel(q, k, v, cpos, qpos, window=window)
        want = cs.plain_decode(q, k, v, cpos, qpos, window=window).float()
        excess = ((out.float() - want).abs() - cs.k1_limit(want)).max().item()
        seen["calls"] += 1
        seen["over"] += excess > 0
        if excess > seen["excess"]:
            seen["excess"] = excess
            seen["inputs"] = [t.clone() for t in (q, k, v, cpos, qpos)] + [window]
        return out

    ops.flash_decode = checked
    try:
        cs.phase_serve(dev, cfg, params=params).pop("params")
    finally:
        ops.flash_decode = kernel
    print(json.dumps({"calls": seen["calls"], "over_the_limit": seen["over"],
                      "worst_excess": seen["excess"]}), flush=True)
    inputs = seen["inputs"]
    torch.save([t.cpu() if torch.is_tensor(t) else t for t in inputs], args.out)
    q, k, v, cpos, qp, window = inputs
    compare(cs, "kernel", ops.flash_decode(q, k, v, cpos, qp, window=window), inputs)


def replay(args) -> None:
    import torch

    cs, dev = _setup(args.src)
    from repro_torch.kernels import ops

    inputs = [t.to(dev) if torch.is_tensor(t) else t
              for t in torch.load(args.file)]
    q, k, v, cpos, qp, window = inputs
    compare(cs, args.label, ops.flash_decode(q, k, v, cpos, qp, window=window),
            inputs)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("timers", "witness", "replay"):
        p = sub.add_parser(name)
        p.add_argument("--src", default=str(ROOT / "src"))
        p.add_argument("--label", default="this checkout")
        if name == "witness":
            p.add_argument("--out", required=True)
        if name == "replay":
            p.add_argument("file")
    args = ap.parse_args()
    {"timers": timers, "witness": witness, "replay": replay}[args.cmd](args)


if __name__ == "__main__":
    main()
