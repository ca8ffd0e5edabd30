"""How far full-width recurrentgemma-9b bf16 prefill and decode logits differ.

    PYTHONPATH=src python -m repro_torch.launch.hybrid_conditioning [--layers N]

Weights from seed 0 drawn in bf16 and ``conditioned`` (wq, wk, wv at std
1/sqrt(d_model)), the first 128 tokens of a B=4 batch from seed 1: the
weights and tokens of ``chip_smoke.py`` phase 10. Prints, at every position
of the 128-token prompt, the largest logit difference of:

1. the forward (K2, K5) against teacher-forced decode (K1 and the O(1)
   recurrence), held against 2e-2 of the largest logit;
2. the same two paths with every kernel replaced by its plain version on
   both sides (the control), held against the same bound;
3. each path with the kernels against itself with the plain versions, and
   each path's kernels against the other path's plain versions;
4. the forward with the embedding table scaled by 1 + 2^-8, and with each
   entry scaled by 1 + 2^-8 or 1 - 2^-8 at random and rounded to bf16,
   against the forward;
5. the same weights upcast to fp32: forward against teacher-forced decode.

These are the measurements behind ROADMAP Queue 3's finding that bf16
cannot resolve prefill against decode at 2e-2 of the largest logit for
this model, with or without the kernels. Exits 0 whatever they read.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses

import torch

from repro_torch.configs.base import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch.inputs import conditioned, make_batch
from repro_torch.launch.ssm_conditioning import compare, nudged, teacher_forced
from repro_torch.models.base import init_tree, resolve_device, tree_map
from repro_torch.models.registry import build_model
from repro_torch.runtime.sharding import Sharder
from repro_torch.train.step import make_prefill_step

B, S, PROMPT = 4, 2048, 128   # chip_smoke.py phase 10's batch and prompt
BOUND = 2e-2                  # of the largest logit


@contextlib.contextmanager
def plain_kernels():
    """Route K1, K2 and K5 through their plain versions."""
    saved = ops.flash_attention, ops.flash_decode, ops.rglru

    def flash(q, k, v, *, causal=True, window=None):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), causal=causal,
                                       window=window).transpose(1, 2)

    def decode(q, k, v, cpos, qpos, *, window=None):
        return ref.flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                    cpos, qpos, window=window)

    ops.flash_attention, ops.flash_decode, ops.rglru = flash, decode, ref.rglru_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode, ops.rglru = saved


def held(what, got, want):
    """``compare``, and whether the gap is within BOUND of the largest logit."""
    compare(what, got, want)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    print(f"   {err / scale * 100:.3f}% of the largest |logit|: "
          f"{'within' if err <= BOUND * scale else 'FAILS'} {BOUND:g} of it "
          f"({BOUND * scale:.4f})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the published 38)")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    cfg = get_arch("recurrentgemma_9b")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model, sharder = build_model(cfg), Sharder(None)
    params = conditioned(cfg, model.compute_params(init_tree(
        torch.Generator(device=dev).manual_seed(0), model.param_specs(),
        cfg.compute_dtype, dev)))
    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev,
                       with_labels=False)
    short = {k: v[:, :PROMPT] for k, v in batch.items()}
    toks = short["tokens"]
    print(f"{cfg.name}: {cfg.n_layers} layers on {dev}, {cfg.compute_dtype}, "
          f"B={B}, {PROMPT} positions", flush=True)

    fwd = make_prefill_step(model, sharder)
    pre_k = fwd(params, short)
    dec_k = teacher_forced(model, params, cfg, toks, dev, sharder)
    with plain_kernels():
        pre_p = fwd(params, short)
        dec_p = teacher_forced(model, params, cfg, toks, dev, sharder)
    held("1. forward (K2, K5) vs teacher-forced decode (K1)", pre_k, dec_k)
    held("2. control: the same, every kernel its plain version on both sides",
         pre_p, dec_p)
    compare("3a. forward, kernels vs plain versions", pre_k, pre_p)
    compare("3b. decode, kernel vs plain version", dec_k, dec_p)
    compare("3c. forward with the kernels vs decode with the plain version",
            pre_k, dec_p)
    compare("3d. forward with the plain versions vs decode with the kernel",
            pre_p, dec_k)
    del dec_k, pre_p, dec_p

    compare("4a. forward, embedding scaled by 1 + 2^-8",
            fwd(nudged(params, 1 + 2 ** -8), short), pre_k)
    tok = params["embed"]["tok"]
    sign = torch.randint(0, 2, tok.shape, device=dev, dtype=torch.int8,
                         generator=torch.Generator(device=dev).manual_seed(7))
    noisy = (tok.float() * (1 + 2 ** -8 * (2 * sign - 1))).to(tok.dtype)
    moved = (noisy != tok).float().mean().item()
    compare(f"4b. forward, each embedding entry scaled by 1 +- 2^-8 at random "
            f"and rounded ({moved * 100:.1f}% of the entries moved)",
            fwd({**params, "embed": {**params["embed"], "tok": noisy}}, short), pre_k)
    del noisy, sign, pre_k

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32)
    params32 = tree_map(lambda t: t.float(), params)  # the same values
    del params
    held("5. fp32: forward (K2, K5) vs teacher-forced decode (K1)",
         make_prefill_step(model32, sharder)(params32, short),
         teacher_forced(model32, params32, cfg32, toks, dev, sharder))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
