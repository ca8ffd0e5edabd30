"""K2 at ``chip_smoke.py`` phase 15b's danube shape on one CUDA card, using
the script's helpers.

    python src/repro_torch/launch/examples_probe.py

K2 at h2o-danube-3-4b's training shape (B=4 S=64 H=32 KV=8 D=120, window
4096): each call of one forward of the full-width 4-layer model on the
trainer's seed-1 init and its first batch, then randn inputs at that shape
(std 1, and scaled to the model's q, k, v std). Each against the plain
version in fp32 (``chip_smoke.plain_flash``) and in fp64, and SDPA: the
largest gaps, the worst element's share of ``chip_smoke.k2_limit`` with
its values, Sum_j p_j |v_j| and its row's top-2 scaled-logit gap.

It prints JSON lines; run from the repository root.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def _setup():
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("examples_probe: needs a CUDA card")
    import chip_smoke

    return chip_smoke, torch.device("cuda", 0)


def _danube():
    from repro_torch.configs.base import get_arch

    return dataclasses.replace(get_arch("h2o_danube_3_4b"), n_layers=4)


def _ref64(q, k, v, window):
    """The plain attention in fp64 (model layout), each row's top-2 scaled
    logit gap."""
    import torch

    B, S, H, D = q.shape
    KV = k.shape[2]
    qd = q.double().transpose(1, 2).reshape(B, KV, H // KV, S, D) * D ** -0.5
    s = torch.einsum("bkgsd,bktd->bkgst", qd, k.double().transpose(1, 2))
    i = torch.arange(S, device=q.device)
    mask = i[:, None] >= i[None, :]
    if window is not None:
        mask &= (i[:, None] - i[None, :]) < window
    s = s.masked_fill(~mask, float("-inf"))
    o = torch.einsum("bkgst,bktd->bkgsd", torch.softmax(s, -1),
                     v.double().transpose(1, 2))
    top = s.topk(2, dim=-1).values
    gap = (top[..., 0] - top[..., 1]).reshape(B, H, S).transpose(1, 2)
    return o.reshape(B, H, S, D).transpose(1, 2), gap


def _k2_row(cs, tag, q, k, v, window) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    got = ops.flash_attention(q, k, v, causal=True, window=window).float()
    want = cs.plain_flash(q, k, v, causal=True, window=window).float()
    spread = cs.plain_flash(q, k, v.abs(), causal=True, window=window).float()
    w64, gap = _ref64(q, k, v, window)
    sdpa = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        enable_gqa=True).transpose(1, 2).float()
    lim = cs.k2_limit(want, spread)
    d = (got - want).abs()
    r = d / lim.clamp_min(1e-30)
    b, s, h, e = (int(t) for t in torch.unravel_index(r.argmax(), r.shape))
    return {"row": tag, "k2_vs_ref32": d.max().item(), "of_k2_limit": r.max().item(),
            "over_limit": int((d > lim).sum()),
            "k2_vs_ref64": (got - w64).abs().max().item(),
            "ref32_vs_ref64": (want - w64).abs().max().item(),
            "sdpa_vs_ref64": (sdpa - w64).abs().max().item(),
            "k2_vs_sdpa": (got - sdpa).abs().max().item(),
            "worst": {"k2": got[b, s, h, e].item(), "ref32": want[b, s, h, e].item(),
                      "ref64": w64[b, s, h, e].item(), "sdpa": sdpa[b, s, h, e].item(),
                      "sum_p_abs_v": spread[b, s, h, e].item(),
                      "limit": lim[b, s, h, e].item(), "gap": gap[b, s, h].item()}}


def main() -> None:
    import torch

    cs, dev = _setup()
    from repro_torch.data.pipeline import SyntheticLMDataset, to_tensors
    from repro_torch.kernels import ops
    from repro_torch.models.base import init_tree
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder

    cfg = _danube()
    model = build_model(cfg)
    params = init_tree(torch.Generator(device=dev).manual_seed(1), model.param_specs(),
                       cfg.param_dtype, dev)
    batch = to_tensors(SyntheticLMDataset(cfg, global_batch=4, seq_len=64,
                                          seed=1).batch_at(0), dev)
    calls, kernel = [], ops.flash_attention

    def capture(q, k, v, *, causal=True, window=None):
        calls.append((q.clone(), k.clone(), v.clone(), window))
        return kernel(q, k, v, causal=causal, window=window)

    ops.flash_attention = capture
    try:
        with torch.no_grad():
            model.forward(params, batch, Sharder(None))
    finally:
        ops.flash_attention = kernel
    print(json.dumps({"card": cs.card()}), flush=True)
    for i, (q, k, v, window) in enumerate(calls):
        print(json.dumps(_k2_row(cs, f"danube layer {i}", q, k, v, window)), flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = cs.flash_inputs(gen, dev, torch.bfloat16, 4, 64, 64, 32, 8, 120)
    print(json.dumps(_k2_row(cs, "randn std 1", q, k, v, 4096)), flush=True)
    scaled = [(t.float() * f).bfloat16() for t, f in ((q, 8), (k, 14), (v, 22))]
    print(json.dumps(_k2_row(cs, "randn q x 8, k x 14, v x 22", *scaled, 4096)),
          flush=True)


if __name__ == "__main__":
    main()
