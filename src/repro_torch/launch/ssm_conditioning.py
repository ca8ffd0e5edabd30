"""How far full-width mamba2-2.7b logits move under last-bit changes.

    PYTHONPATH=src python -m repro_torch.launch.ssm_conditioning [--layers N]

Random weights from seed 0, tokens from seed 1; "published" is the same
tree with Mamba-2's dt and A init (``mamba2.published_dt_A``, seed 5).
Prints, and bounds nothing:

1. the fp32 forward (K4) against teacher-forced decode at every position
   of a 128-token prompt, on the specs' own init;
2. how far scaling the embedding table by 1 + 2^-23 (about one fp32 ulp)
   moves those fp32 forward logits;
3. the bf16 logits of a B=4, S=2048 forward with K4 against the chunked scan,
   on the published and on the own init;
4. how far scaling the bf16 embedding table by 1 + 2^-8 (about one bf16
   ulp) moves the bf16 forward logits on the published init.

These are the measurements behind ROADMAP Queue 3's finding that the
specs' init, and bf16 at 64 layers on either init, make the logits
chaotic, so that ``chip_smoke.py`` holds the SSM path per K4 call and its
forward-vs-decode logits on the published init in fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops
from repro_torch.launch.inputs import make_batch, make_decode_inputs
from repro_torch.models.base import init_tree, resolve_device
from repro_torch.models.mamba2 import published_dt_A, ssd_chunked
from repro_torch.models.registry import build_model
from repro_torch.runtime.sharding import Sharder
from repro_torch.train.step import make_prefill_step

B, S = 4, 2048   # the bf16 forward, as chip_smoke.py's
PROMPT = 128     # fp32 forward vs teacher-forced decode


@contextlib.contextmanager
def chunked_scan():
    """Route the model's scan through the chunked algebra, not K4."""
    kernel = ops.ssd_scan
    ops.ssd_scan = lambda x, dt, A, Bm, Cm, chunk=256: ssd_chunked(x, dt, A, Bm, Cm, chunk)
    try:
        yield
    finally:
        ops.ssd_scan = kernel


def nudged(params, factor):
    return {**params, "embed": {**params["embed"], "tok": params["embed"]["tok"] * factor}}


def compare(what, got, want):
    by_pos = (got.float() - want.float()).abs().amax(dim=(0, 2))
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"{what}: max_abs_err={by_pos.max().item():.3e} of the largest |logit| "
          f"{want.float().abs().max().item():.3f}, argmax agreement "
          f"{agree * 100:.2f}%; by position, the first 8: "
          f"{[round(v, 6) for v in by_pos[:8].tolist()]}", flush=True)


def teacher_forced(model, params, cfg, toks, dev, sharder):
    """Logits [B,T,V] of decoding toks [B,T] one token at a time."""
    rows, T = toks.shape
    cache, _, _ = make_decode_inputs(cfg, rows, T, torch.Generator(device=dev), dev)
    out = []
    with torch.inference_mode():
        for t in range(T):
            pos = torch.full((rows,), t, dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(params, cache, toks[:, t], pos, sharder)
            out.append(logits.float())
    return torch.stack(out, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the published 64)")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    cfg = get_arch("mamba2_2_7b")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model, model32, sharder = build_model(cfg), build_model(cfg32), Sharder(None)
    own = init_tree(torch.Generator(device=dev).manual_seed(0), model.param_specs(),
                    cfg.param_dtype, dev)
    published = published_dt_A(own, torch.Generator(device=dev).manual_seed(5))
    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev,
                       with_labels=False)
    print(f"{cfg.name}: {cfg.n_layers} layers on {dev}, B={B}", flush=True)

    fwd32 = make_prefill_step(model32, sharder)
    short = {k: v[:, :PROMPT] for k, v in batch.items()}
    pre = fwd32(own, short)
    compare(f"1. fp32 forward vs teacher-forced decode, {PROMPT} positions, "
            f"own init", pre, teacher_forced(model32, own, cfg32, short["tokens"],
                                             dev, sharder))
    compare("2. fp32 forward, own init, embedding scaled by 1 + 2^-23",
            fwd32(nudged(own, 1 + 2 ** -23), short), pre)
    del pre

    fwd = make_prefill_step(model, sharder)
    for name, p32 in (("published", published), ("own", own)):
        p = model.compute_params(p32)
        got = fwd(p, batch)
        with chunked_scan():
            want = fwd(p, batch)
        compare(f"3. bf16 forward B={B} S={S}, K4 vs the chunked "
                f"scan, {name} init", got, want)
        if name == "published":
            compare("4. bf16 forward, published init, embedding scaled by 1 + 2^-8",
                    fwd(nudged(p, 1 + 2 ** -8), batch), got)
        del p, got, want
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
