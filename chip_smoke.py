#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's two paths at full width with random weights from a
seed: serving smollm-360m (decode, kernel K1) and the full-sequence
forward of smollm-360m and hubert-xlarge (prefill, kernel K2). Checks every
hand-written kernel on them against its plain torch version. Phases, each
fatal on failure:

1. build   nvcc builds the paths' kernels from src/repro_torch/kernels/csrc,
           one process a source, all at once, and ptxas reports registers,
           shared memory and spills.
2. kernels each kernel against its plain version on the card, fp32 with
           rtol=atol=1e-4 (the sums run in another order) and bf16 with
           2e-2 (one bf16 rounding of the output): K1 at the decode cases,
           K2 at the cases of the CPU tests and at the smollm-360m, hubert
           and danube prefill shapes and at non-divisible lengths.
3. serve   two full smollm-360m InferenceServers and a Gateway on the port's
           UsfRuntime(Topology(2,1), SchedCoop) answer four clients; the
           kernel's launch count must equal n_layers x engine steps.
4. parity  16 teacher-forced decode steps at full width in bf16: every
           attention call of the kernel against the plain version on the
           same inputs (2e-2), and the logits with the kernel and with the
           plain attention (2e-2 of the largest logit) on weights whose
           attention scores are O(1) (see `conditioned`).
5. timing  the kernel, its plain version and a library call computing the
           same function, at the serve shape and at a long cache (CUDA
           events, L2 flushed before each launch); engine step time.
6. prefill make_prefill_step on full-width smollm-360m (32 layers, B=4,
           S=2048) and hubert-xlarge (48 layers, B=4, S=1024 frames) in
           bf16: K2's launch count must rise by n_layers a forward; every
           K2 call of the smollm forward against the plain version on the
           same inputs (2e-2 + 2e-2 relative + the bound of K2's bf16
           probabilities, see `checked_prefill_attention`); the logits of both models against the plain
           attention path on `conditioned` weights (2e-2 of the largest
           logit); and the prefill logits of a 128-token prompt at every
           position against teacher-forced decode (K1) on the same weights.
7. timing  K2, its plain version and scaled_dot_product_attention (the
           yardstick, never called by the port) at the smollm-360m and
           hubert prefill shapes and at a 32k-token row; the full-width
           forward's wall time and tokens/s; a profile of one forward.

Prints a {"kernels": [...]} line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # CUDA cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
DECODE_REPLACES = "src/repro/kernels/decode_attention.py:67"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:88"
KERNELS = ("decode_attention", "flash_attention")


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# decode-attention inputs
# --------------------------------------------------------------------------- #
def decode_inputs(gen, dev, dtype, B, H, KV, W, D, q_pos, *, masked_rows=()):
    """q [B,H,D]; k, v in model layout [B,W,KV,D]; cache_pos [B,W] as a ring
    buffer holds them: slot w has the newest position p <= q_pos[b] with
    p % W == w (or -1), so q_pos >= W gives a wrapped ring."""
    import torch

    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, W, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, W, KV, D, generator=gen, device=dev).to(dtype)
    qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    w = torch.arange(W, device=dev, dtype=torch.int64)
    p = qp[:, None].long() - torch.remainder(qp[:, None].long() - w, W)
    cpos = torch.where(p >= 0, p, -1).to(torch.int32)
    for b in masked_rows:
        cpos[b] = -1
    return q, k, v, cpos.contiguous(), qp


def plain_decode(q, k, v, cpos, qpos, *, window=None):
    """The plain version of ops.flash_decode (model layout)."""
    from repro_torch.kernels import ref

    return ref.flash_decode_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                cpos, qpos, window=window)


@contextlib.contextmanager
def plain_attention():
    """Route the model's decode attention through the plain version."""
    from repro_torch.kernels import ops

    kernel = ops.flash_decode
    ops.flash_decode = plain_decode
    try:
        yield
    finally:
        ops.flash_decode = kernel


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load_all(list(KERNELS))
    log(f"[build] {', '.join(f'{n}.cu' for n in KERNELS)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


DECODE_CASES = [
    # name, B, H, KV, W, D, q_pos, window, masked rows
    ("test_kernels-a g1", 1, 4, 4, 64, 32, [37], None, ()),
    ("test_kernels-a g2 w48", 1, 4, 2, 64, 32, [60], 48, ()),
    ("test_kernels-b g2 w48", 2, 8, 4, 128, 16, [5, 60], 48, ()),
    ("test_kernels-b g1", 2, 8, 8, 128, 16, [20, 127], None, ()),
    ("smollm smoke G3 D20", 2, 3, 1, 32, 20, [10, 31], None, ()),
    ("smollm full G3 D64", 4, 15, 5, 512, 64, [0, 100, 300, 511], None, ()),
    ("long cache W32768", 4, 15, 5, 32768, 64, [32767, 20000, 5000, 32767], None, ()),
    ("ring W48 window 48", 3, 15, 5, 48, 64, [47, 100, 1000], 48, ()),
    ("linear W200 window 48", 2, 15, 5, 200, 64, [150, 199], 48, ()),
    ("fully masked row", 2, 15, 5, 96, 64, [5, 70], None, (0,)),
    ("D80 G4 W200", 2, 8, 2, 200, 80, [199, 120], None, ()),
    ("D120 G4 W200", 2, 8, 2, 200, 120, [199, 120], None, ()),
    ("D128 G8 W130", 2, 8, 1, 130, 128, [129, 64], None, ()),
    ("D256 G2 W70", 1, 4, 2, 70, 256, [69], None, ()),
]


def phase_kernels(dev) -> float:
    """K1 against its plain version; returns the largest abs error."""
    import torch

    from repro_torch.kernels import decode_attention, ops

    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).removeprefix("torch.")]
        for name, B, H, KV, W, D, qpos, window, masked in DECODE_CASES:
            q, k, v, cpos, qp = decode_inputs(gen, dev, dtype, B, H, KV, W, D,
                                              qpos, masked_rows=masked)
            layouts = {"model layout": (ops.flash_decode, k, v)}
            if W <= 512:  # the kernel's own layout, contiguous
                layouts["kernel layout"] = (
                    lambda q, k, v, c, p, *, window: decode_attention.flash_decode(
                        q, k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), c, p, window=window),
                    k, v)
            expect = plain_decode(q, k, v, cpos, qp, window=window).float()
            for lay, (fn, kk, vv) in layouts.items():
                out = fn(q, kk, vv, cpos, qp, window=window)
                torch.cuda.synchronize()
                got = out.float()
                err = (got - expect).abs().max().item()
                worst = max(worst, err)
                ok = torch.allclose(got, expect, rtol=tol, atol=tol)
                for b in masked:
                    ok = ok and bool((got[b] == 0).all())
                log(f"[kernels] flash_decode {name:24s} {lay:12s} "
                    f"{str(dtype):14s} max_abs_err={err:.3e} tol={tol:g} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_decode disagrees with its "
                                         f"plain version: {name}, {lay}, {dtype}")
    return worst


# --------------------------------------------------------------------------- #
# K2: full-sequence attention
# --------------------------------------------------------------------------- #
def flash_inputs(gen, dev, dtype, B, Sq, Sk, H, KV, D):
    """q [B,Sq,H,D]; k, v [B,Sk,KV,D]: the model layout."""
    import torch

    q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, D, generator=gen, device=dev).to(dtype)
    return q, k, v


def plain_flash(q, k, v, *, causal=True, window=None):
    """The plain version of ops.flash_attention (model layout)."""
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)


@contextlib.contextmanager
def plain_prefill_attention():
    """Route the model's full-sequence attention through the plain version."""
    from repro_torch.kernels import ops

    kernel = ops.flash_attention
    ops.flash_attention = plain_flash
    try:
        yield
    finally:
        ops.flash_attention = kernel


FLASH_CASES = [
    # name, B, Sq, Sk, H, KV, D, causal, window
    *[(f"test_kernels B{b} H{h} S{s} D{d} G{g} {m}", b, s, s, h, h // g, d,
       m != "bidir", 32 if m == "w32" else None)
      for b, h, s, d in ((1, 4, 128, 32), (2, 6, 256, 64), (1, 8, 64, 16))
      for g in (1, 2) for m in ("causal", "w32", "bidir")],
    ("test_kernels S100 non-divisible", 1, 100, 100, 2, 2, 32, True, None),
    ("smollm smoke G3 D20", 2, 40, 40, 3, 1, 20, True, None),
    ("danube narrow D120 G4 w64", 1, 300, 300, 8, 2, 120, True, 64),
    ("Sq70 Sk130 causal G3", 2, 70, 130, 6, 2, 64, True, None),
    ("window 0 (all masked)", 1, 64, 64, 2, 1, 64, True, 0),
    ("smollm prefill B4 S2048", 4, 2048, 2048, 15, 5, 64, True, None),
    ("hubert B4 S1024 bidir", 4, 1024, 1024, 16, 16, 80, False, None),
    ("danube B1 S6144 w4096", 1, 6144, 6144, 32, 8, 120, True, 4096),
    ("smollm S1000 non-divisible", 2, 1000, 1000, 15, 5, 64, True, None),
    ("hubert S777 bidir non-divisible", 2, 777, 777, 16, 16, 80, False, None),
]


def phase_flash_kernels(dev) -> float:
    """K2 against its plain version; returns the largest abs error."""
    import torch

    from repro_torch.kernels import flash_attention, ops

    gen = torch.Generator(device=dev).manual_seed(4321)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).removeprefix("torch.")]
        for name, B, Sq, Sk, H, KV, D, causal, window in FLASH_CASES:
            q, k, v = flash_inputs(gen, dev, dtype, B, Sq, Sk, H, KV, D)
            layouts = {"model layout": lambda q, k, v: ops.flash_attention(
                q, k, v, causal=causal, window=window)}
            if Sq <= 512:  # the kernel's own layout, contiguous
                layouts["kernel layout"] = lambda q, k, v: flash_attention.\
                    flash_attention_fwd(
                        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal,
                        window=window).transpose(1, 2)
            expect = plain_flash(q, k, v, causal=causal, window=window).float()
            for lay, fn in layouts.items():
                got = fn(q, k, v)
                torch.cuda.synchronize()
                got = got.float()
                err = (got - expect).abs().max().item()
                worst = max(worst, err)
                ok = got.shape == expect.shape and torch.allclose(
                    got, expect, rtol=tol, atol=tol)
                log(f"[kernels] flash_attention {name:34s} {lay:12s} "
                    f"{str(dtype):14s} max_abs_err={err:.3e} tol={tol:g} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention disagrees with its "
                                         f"plain version: {name}, {lay}, {dtype}")
            del q, k, v, expect
    return worst


def phase_serve(dev, cfg, *, prompt_len=32, max_new=32, clients=4):
    """Two servers + a gateway answer `clients` requests; returns stats."""
    import torch

    from repro_torch.core.policies import SchedCoop
    from repro_torch.core.threads import UsfRuntime
    from repro_torch.core.topology import Topology
    from repro_torch.kernels import decode_attention
    from repro_torch.serve.engine import Gateway, InferenceServer

    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        servers = [InferenceServer(f"srv-{c}", cfg, usf, max_batch=4,
                                   max_len=512, seed=0, nice=10, device=dev)
                   for c in "ab"]
        torch.cuda.synchronize()
        gw = Gateway(usf, servers)
        g = torch.Generator().manual_seed(7)
        prompts = [torch.randint(0, cfg.vocab, (prompt_len,), generator=g).tolist()
                   for _ in range(clients)]
        results: dict[int, dict] = {}

        def client(i):
            return lambda: results.__setitem__(
                i, gw.handle(prompts[i], max_new=max_new, timeout=600.0))

        decode_attention.flash_decode.launches = 0
        t0 = time.perf_counter()
        for s in servers:
            s.start()
        tasks = [usf.create(client(i), job=gw.job, name=f"client{i}")
                 for i in range(clients)]
        for t in tasks:
            if not usf.join(t, timeout=900.0):
                raise AssertionError(f"client {t} did not finish")
        wall = time.perf_counter() - t0
        launches = decode_attention.flash_decode.launches
        for s in servers:
            s.stop()
        served = [s.served for s in servers]
        steps = [s.steps for s in servers]
    finally:
        usf.shutdown(timeout=10.0)

    if len(results) != clients or served != [clients] * len(servers):
        raise AssertionError(f"served {served}, results {len(results)} "
                             f"of {clients}")
    for i, r in results.items():
        for name, out in r["outputs"].items():
            if len(out) != max_new or not all(0 <= t < cfg.vocab for t in out):
                raise AssertionError(f"client {i} {name}: bad output {out}")
    want = cfg.n_layers * sum(steps)
    log(f"[serve] {clients} clients x {len(servers)} servers served {served}; "
        f"engine steps {steps}; flash_decode launches {launches} "
        f"(want n_layers {cfg.n_layers} x {sum(steps)} = {want})")
    if launches != want:
        raise AssertionError(f"flash_decode launched {launches} times, "
                             f"want {want}: decode attention bypassed the kernel")
    same = sum(r["outputs"]["srv-a"] == r["outputs"]["srv-b"]
               for r in results.values())
    tokens = sum(len(o) for r in results.values() for o in r["outputs"].values())
    lat = sorted(r["latency"] for r in results.values())
    log(f"[serve] wall {wall:.3f} s; {tokens} generated tokens "
        f"({tokens / wall:.1f} tok/s, prefill {prompt_len} x "
        f"{clients * len(servers)} more); request latency s {lat}; "
        f"identical outputs on both servers (same seed) for {same}/{clients}")
    return {"launches": launches, "steps": sum(steps), "wall_s": wall,
            "tok_per_s": tokens / wall, "params": servers[0].params}


def decode_run(model, params, cache, toks, sharder, *, same_state=False):
    """Teacher-force toks [T,B]; returns the logits [T,B,V] in fp32.

    With ``same_state`` each step also runs the plain attention on a copy
    of the cache the kernel path holds, and returns both logits."""
    import torch

    out, plain = [], []
    B = toks.shape[1]
    for t in range(toks.shape[0]):
        pos = torch.full((B,), t, dtype=torch.int32, device=toks.device)
        if same_state:
            copy = {"layers": {k: v.clone() for k, v in cache["layers"].items()}}
            with plain_attention():
                logits, _ = model.decode_step(params, copy, toks[t], pos, sharder)
            plain.append(logits.float())
        logits, cache = model.decode_step(params, cache, toks[t], pos, sharder)
        out.append(logits.float())
    return (torch.stack(out), torch.stack(plain)) if same_state else torch.stack(out)


def fresh_cache(cfg, B, max_len, dev):
    import torch

    from repro_torch.launch.inputs import make_decode_inputs

    cache, _, _ = make_decode_inputs(cfg, B, max_len,
                                     torch.Generator(device=dev).manual_seed(1), dev)
    return cache


@contextlib.contextmanager
def checked_attention(tol):
    """Run the kernel and, on the same inputs, the plain version at every
    decode-attention call; yields the list of (max abs err, worst excess
    over the tolerance) per call."""
    from repro_torch.kernels import ops

    kernel, found = ops.flash_decode, []

    def checked(q, k, v, cpos, qpos, *, window=None):
        out = kernel(q, k, v, cpos, qpos, window=window)
        want = plain_decode(q, k, v, cpos, qpos, window=window).float()
        d = (out.float() - want).abs()
        found.append((d.max(), (d - tol - tol * want.abs()).max()))
        return out

    ops.flash_decode = checked
    try:
        yield found
    finally:
        ops.flash_decode = kernel


def conditioned(cfg, params):
    """``params`` with wq, wk and wv rescaled to std 1/sqrt(d_model).

    The model's init (as the JAX package's) takes the fan-in of wq [d,H,hd]
    and wk, wv [d,KV,hd] as H and KV, so at full width q and k entries have
    std ~8 and ~14 and attention scores std ~100: a near-hard argmax that
    turns a last-bit difference into an O(1) logit change (phase 4c). With
    the d_model fan-in the scores are O(1), as in a trained model, and a
    logits comparison measures the kernel rather than that amplification."""
    import math

    attn = dict(params["layers"]["attn"])
    for key, n in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                   ("wv", cfg.n_kv_heads)):
        attn[key] = attn[key] * math.sqrt(n / cfg.d_model)
    return {**params, "layers": {**params["layers"], "attn": attn}}


def phase_parity(dev, cfg, params, *, steps=16, B=4):
    """Full width, `steps` teacher-forced decode steps of B rows in bf16:

    a. with the servers' weights, at every decode-attention call the kernel
       and the plain version see the same model-made inputs and agree
       within 2e-2 (plus 2e-2 relative);
    b. with ``conditioned`` weights, the logits with the kernel and with
       the plain attention, each through its own cache, agree within 2e-2
       of the largest logit. An element-wise 2e-2 is below what bf16
       allows here: one flipped rounding in an attention output moves a
       logit of ~1 by several bf16 ulps (4.7e-2) 32 layers later;
    c. with the servers' weights the same comparison, and one in fp32 from
       one cache state per step: printed, not bounded (see ``conditioned``
       and ROADMAP Queue 3)."""
    import dataclasses

    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder

    model, sharder = build_model(cfg), Sharder(None)
    toks = torch.randint(0, cfg.vocab, (steps, B), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(3))

    def kernel_and_plain(p, c=cfg, m=model):
        got = decode_run(m, p, fresh_cache(c, B, 512, dev), toks, sharder)
        with plain_attention():
            want = decode_run(m, p, fresh_cache(c, B, 512, dev), toks, sharder)
        return got, want

    def per_step(a, b):
        return " ".join(f"{x:.3g}" for x in (a - b).abs().amax(dim=(1, 2)).tolist())

    with torch.inference_mode():
        with checked_attention(TOL["bfloat16"]) as found:
            decode_run(model, params, fresh_cache(cfg, B, 512, dev), toks, sharder)
        got, want = kernel_and_plain(conditioned(cfg, params))
        raw_k, raw_p = kernel_and_plain(params)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        model32 = build_model(cfg32)
        k32, p32 = decode_run(model32, model32.compute_params(params),
                              fresh_cache(cfg32, B, 512, dev), toks, sharder,
                              same_state=True)

    calls = len(found)
    attn_err = max(e.item() for e, _ in found)
    attn_ok = calls == steps * cfg.n_layers and max(x.item() for _, x in found) <= 0
    log(f"[parity] a. bf16 decode attention at every call of {steps} full-width "
        f"steps x B={B}: {calls} calls, max_abs_err={attn_err:.3e} "
        f"(tol 2e-2 + 2e-2 relative) {'ok' if attn_ok else 'FAIL'}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= 2e-2 * scale
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[parity] b. bf16 logits, conditioned weights, kernel vs plain attention: "
        f"max_abs_err={err:.3e} (tol 2e-2 of the largest |logit|, {scale:.3f}), "
        f"greedy-token agreement {agree * 100:.2f}%; per step "
        f"[{per_step(got, want)}] {'ok' if ok else 'FAIL'}")
    raw_agree = (raw_k.argmax(-1) == raw_p.argmax(-1)).float().mean().item()
    log(f"[parity] c. not bounded, the servers' weights: bf16 logits kernel vs "
        f"plain per step [{per_step(raw_k, raw_p)}], greedy-token agreement "
        f"{raw_agree * 100:.2f}%; fp32 logits kernel vs plain from one cache "
        f"state per step [{per_step(k32, p32)}]")
    if not (attn_ok and ok):
        raise AssertionError("the kernel disagrees with the plain attention at "
                             "full width")
    return attn_err


def time_ms(fn, flush, iters=50, warmup=5) -> float:
    """Median device time of one call, the L2 flushed before each."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def decode_bound(B, H, KV, W, D, dtype_name):
    es = 2 if dtype_name == "bfloat16" else 4
    moved = 2 * B * H * D * es + 2 * B * W * KV * D * es + 4 * B * W + 4 * B
    flops = 4 * B * H * W * D
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_decode_shape(dev, flush, B, H, KV, W, D):
    """Kernel, plain and library times at one shape, every slot valid."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, cpos, qp = decode_inputs(gen, dev, torch.bfloat16, B, H, KV, W, D,
                                      [W - 1] * B)
    q4 = q[:, :, None, :]
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    mask = ((cpos >= 0) & (cpos <= qp[:, None]))[:, None, None, :]
    row = {
        "ms": time_ms(lambda: ops.flash_decode(q, k, v, cpos, qp), flush),
        "plain_ms": time_ms(lambda: plain_decode(q, k, v, cpos, qp), flush),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q4, kT, vT, attn_mask=mask, enable_gqa=True), flush),
    }
    row["bound_ms"], row["bound_by"] = decode_bound(B, H, KV, W, D, "bfloat16")
    row["shape"] = f"B={B} H={H} KV={KV} W={W} D={D} bf16, model layout"
    return row


def time_engine_step(dev, cfg, params, *, B=4, steps=30):
    """Host-clock ms of one full-width decode step (synchronised), with
    the kernel and with the plain attention."""
    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder

    model, sharder = build_model(cfg), Sharder(None)
    toks = torch.randint(0, cfg.vocab, (steps + 5, B), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(9))

    def run():
        cache = fresh_cache(cfg, B, 512, dev)
        times = []
        with torch.inference_mode():
            for t in range(steps + 5):
                pos = torch.full((B,), t, dtype=torch.int32, device=dev)
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, toks[t], pos, sharder)
                logits.argmax(-1).cpu()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[5:])

    kernel_ms = run()
    with plain_attention():
        plain_ms = run()
    return kernel_ms, plain_ms


def profile_steps(dev, cfg, params, *, B=4, steps=3):
    """torch.profiler over `steps` full-width decode steps (after one
    warm-up step): device-busy ms, kernel launches and K1's device ms, each
    per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder

    model, sharder = build_model(cfg), Sharder(None)
    cache = fresh_cache(cfg, B, 512, dev)
    toks = torch.zeros(B, dtype=torch.int32, device=dev)

    def step(t):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        logits, _ = model.decode_step(params, cache, toks, pos, sharder)
        logits.argmax(-1).cpu()

    with torch.inference_mode():
        step(0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for t in range(1, steps + 1):
                step(t)
    busy, launches, k1 = device_totals(prof, "flash_decode_kernel")
    return busy / steps, launches / steps, k1 / steps


# --------------------------------------------------------------------------- #
# prefill (K2's path)
# --------------------------------------------------------------------------- #
def model_params(cfg, dev, seed=0):
    """The model, its compute-dtype params from ``seed`` on the card."""
    import torch

    from repro_torch.models.base import init_tree
    from repro_torch.models.registry import build_model

    model = build_model(cfg)
    params = init_tree(torch.Generator(device=dev).manual_seed(seed),
                       model.param_specs(), cfg.param_dtype, dev)
    return model, model.compute_params(params)


@contextlib.contextmanager
def checked_prefill_attention(tol):
    """Run K2 and, on the same inputs, the plain version at every
    full-sequence attention call; yields (max abs err, worst excess over
    the bound) per call.

    The bound is tol + tol * |want| (as for K1) plus 2^-8 * sum_j p_j |v_j|:
    K2 rounds the probabilities to bf16 for the P V product on the tensor
    cores (as the TPU kernel's default-precision dot does on the MXU), and
    a relative rounding of at most 2^-8 on each p_j moves the output by at
    most that much. With the model's init |v| reaches ~60 (the fan-in
    finding of ROADMAP Queue 3), so the term matters where outputs cancel
    to near 0. sum_j p_j |v_j| is the plain version run on |v|."""
    from repro_torch.kernels import ops

    kernel, found = ops.flash_attention, []

    def checked(q, k, v, *, causal=True, window=None):
        out = kernel(q, k, v, causal=causal, window=window)
        want = plain_flash(q, k, v, causal=causal, window=window).float()
        spread = plain_flash(q, k, v.abs(), causal=causal, window=window).float()
        d = (out.float() - want).abs()
        found.append((d.max(), (d - tol - tol * want.abs() - 2 ** -8 * spread).max()))
        return out

    ops.flash_attention = checked
    try:
        yield found
    finally:
        ops.flash_attention = kernel


def logits_close(got, want, what):
    """Logits within 2e-2 of the largest |logit| (see phase_parity b)."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= 2e-2 * scale
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[prefill] {what}: max_abs_err={err:.3e} (tol 2e-2 of the largest "
        f"|logit|, {scale:.3f}), argmax agreement {agree * 100:.2f}% "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_prefill(dev, *, B=4):
    """The full-width forward of smollm-360m (S=2048) and hubert-xlarge
    (S=1024) through make_prefill_step; returns K2's launches and results."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.inputs import make_batch
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step

    sharder = Sharder(None)
    runs, ok = {}, True
    for arch, S in (("smollm_360m", 2048), ("hubert_xlarge", 1024)):
        cfg = get_arch(arch)
        model, params = model_params(cfg, dev)
        batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1),
                           dev, with_labels=False)
        step = make_prefill_step(model, sharder)
        torch.cuda.synchronize()
        flash_attention.flash_attention_fwd.launches = 0
        logits = step(params, batch)
        torch.cuda.synchronize()
        launches = flash_attention.flash_attention_fwd.launches
        good = (tuple(logits.shape) == (B, S, cfg.vocab)
                and bool(torch.isfinite(logits).all()) and launches == cfg.n_layers)
        log(f"[prefill] {cfg.name}: {cfg.n_layers}L d_model {cfg.d_model} H "
            f"{cfg.n_heads} KV {cfg.n_kv_heads} hd {cfg.hd}, B={B} S={S} "
            f"{cfg.compute_dtype}: logits {tuple(logits.shape)}, finite "
            f"{bool(torch.isfinite(logits).all())}; flash_attention launches "
            f"{launches} (want n_layers {cfg.n_layers}) {'ok' if good else 'FAIL'}")
        ok &= good
        runs[arch] = {"cfg": cfg, "model": model, "params": params,
                      "batch": batch, "launches": launches}
        del logits

    # a. every K2 call of the smollm forward against the plain version
    r = runs["smollm_360m"]
    with checked_prefill_attention(TOL["bfloat16"]) as found:
        make_prefill_step(r["model"], sharder)(r["params"], r["batch"])
    attn_err = max(e.item() for e, _ in found)
    good = len(found) == r["cfg"].n_layers and max(x.item() for _, x in found) <= 0
    log(f"[prefill] a. {r['cfg'].name} bf16 K2 calls against the plain version on the "
        f"model's inputs: {len(found)} calls, max_abs_err={attn_err:.3e} (tol 2e-2 "
        f"+ 2e-2 relative + 2^-8 sum_j p_j |v_j|, the bf16 rounding of P) "
        f"{'ok' if good else 'FAIL'}")
    ok &= good

    # b. logits, kernel vs plain attention, on conditioned weights
    for arch, r in runs.items():
        step = make_prefill_step(r["model"], sharder)
        cond = conditioned(r["cfg"], r["params"])
        got = step(cond, r["batch"])
        with plain_prefill_attention():
            want = step(cond, r["batch"])
        ok &= logits_close(got, want, f"b. {r['cfg'].name} bf16 logits, conditioned "
                           f"weights, K2 vs plain attention")
        del got, want

    # c. prefill (K2) against teacher-forced decode (K1) at every position
    r = runs["smollm_360m"]
    cond = conditioned(r["cfg"], r["params"])
    toks = r["batch"]["tokens"][:, :128]
    pre = make_prefill_step(r["model"], sharder)(
        cond, {"tokens": toks, "positions": r["batch"]["positions"][:, :128]})
    with torch.inference_mode():
        dec = decode_run(r["model"], cond, fresh_cache(r["cfg"], B, 128, dev),
                         toks.t().contiguous(), sharder).transpose(0, 1)
    ok &= logits_close(pre, dec, f"c. {r['cfg'].name} bf16 logits at all 128 positions, "
                       "prefill (K2) vs teacher-forced decode (K1), conditioned "
                       "weights")
    if not ok:
        raise AssertionError("the prefill path failed its checks")
    return {"launches": sum(r["launches"] for r in runs.values()),
            "attn_err": attn_err, "runs": runs}


def attention_pairs(S, causal, window):
    """Unmasked (query, key) pairs of one head at Sq = Sk = S."""
    if not causal:
        return S * S if window is None else sum(min(S, i + window) for i in range(S))
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_bound(B, S, H, KV, D, causal, window, dtype_name):
    es = 2 if dtype_name == "bfloat16" else 4
    moved = (2 * B * S * H * D + 2 * B * S * KV * D) * es
    flops = 4 * B * H * D * attention_pairs(S, causal, window)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_flash_shape(dev, flush, B, S, H, KV, D, causal, *, window=None,
                     plain="materialised", iters=20, plain_iters=10):
    """K2, plain and library times at one prefill shape, model layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.models import attention

    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = flash_inputs(gen, dev, torch.bfloat16, B, S, S, H, KV, D)
    qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mode = "causal" if causal else "bidir"
    if plain == "materialised":
        plain_fn = lambda: plain_flash(q, k, v, causal=causal, window=window)
    else:  # the streaming plain version: the materialised one would not fit
        plain_fn = lambda: attention._chunked_attention(q, k, v, mode, window, 1024)
    row = {
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                  window=window), flush, iters),
        "plain_ms": time_ms(plain_fn, flush, plain_iters, warmup=1),
        "library_ms": None,
    }
    if window is None:
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qT, kT, vT, is_causal=causal, enable_gqa=True), flush, iters)
    row["bound_ms"], row["bound_by"] = flash_bound(B, S, H, KV, D, causal, window,
                                                   "bfloat16")
    row["shape"] = (f"B={B} S={S} H={H} KV={KV} D={D} {mode}"
                    f"{'' if window is None else f' window {window}'} bf16, "
                    f"model layout; plain = {plain}")
    return row


def time_forward(dev, run, *, iters=5):
    """Host-clock ms of one full-width forward (synchronised), with K2 and
    with the plain attention."""
    import torch

    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step

    step = make_prefill_step(run["model"], Sharder(None))

    def timed():
        times = []
        for _ in range(iters + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(run["params"], run["batch"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    kernel_ms = timed()
    with plain_prefill_attention():
        plain_ms = timed()
    return kernel_ms, plain_ms


def profile_forward(run):
    """torch.profiler over one full-width forward (after a warm-up one):
    device-busy ms, kernel launches and K2's device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step

    step = make_prefill_step(run["model"], Sharder(None))
    step(run["params"], run["batch"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(run["params"], run["batch"])
        torch.cuda.synchronize()
    return device_totals(prof, "flash_fwd_")


def device_totals(prof, kernel_key):
    """(device-busy ms, kernel launches, ms of kernels named kernel_key*)."""
    from torch.autograd import DeviceType

    busy = mine = 0.0
    launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:  # kernels, copies, memsets
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            busy += dev_us
            if kernel_key in e.key:
                mine += dev_us
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += e.count
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy / 1e3, launches, mine / 1e3


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


# --------------------------------------------------------------------------- #
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "a card and has nothing to run here", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import get_arch

    dev = torch.device("cuda", 0)
    cfg = get_arch("smollm_360m")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; config {cfg.name}: "
        f"{cfg.n_layers}L d_model {cfg.d_model} H {cfg.n_heads} KV "
        f"{cfg.n_kv_heads} hd {cfg.hd} d_ff {cfg.d_ff} vocab {cfg.vocab}, "
        f"{cfg.compute_dtype} compute, {cfg.param_dtype} params")

    phase_build()
    max_err = phase_kernels(dev)
    flash_err = phase_flash_kernels(dev)
    serve = phase_serve(dev, cfg)
    params = serve.pop("params")
    phase_parity(dev, cfg, params)
    prefill = phase_prefill(dev)

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    B, H, KV, D = 4, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    serve_row = time_decode_shape(dev, flush, B, H, KV, 512, D)
    long_row = time_decode_shape(dev, flush, B, H, KV, 32768, D)
    for tag, row in (("serve", serve_row), ("long", long_row)):
        log(f"[timing] flash_decode {tag} shape ({row['shape']}): "
            f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
            f"library_ms={row['library_ms']:.6f} (scaled_dot_product_attention, "
            f"yardstick) bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    step_ms, plain_step_ms = time_engine_step(dev, cfg, params)
    log(f"[timing] full-width decode step B=4: {step_ms:.3f} ms with the kernel, "
        f"{plain_step_ms:.3f} ms with the plain attention; engine "
        f"{serve['tok_per_s']:.1f} generated tok/s over {serve['steps']} steps "
        f"in {serve['wall_s']:.3f} s")
    busy_ms, launches, k1_ms = profile_steps(dev, cfg, params)
    log(f"[profile] full-width decode step B=4 (torch.profiler, 3 steps): device "
        f"busy {busy_ms:.3f} ms a step ({busy_ms / step_ms * 100:.1f}% of the "
        f"{step_ms:.3f} ms step, idle {100 - busy_ms / step_ms * 100:.1f}%); "
        f"{launches:.0f} kernel launches a step; flash_decode {k1_ms:.3f} ms a "
        f"step ({k1_ms / busy_ms * 100:.1f}% of device time)")
    del params

    rows = {
        "smollm": time_flash_shape(dev, flush, 4, 2048, H, KV, D, True),
        "hubert": time_flash_shape(dev, flush, 4, 1024, 16, 16, 80, False),
        "long": time_flash_shape(dev, flush, 1, 32768, H, KV, D, True,
                                 plain="chunked", iters=5, plain_iters=2),
    }
    for tag, row in rows.items():
        lib = ("n/a" if row["library_ms"] is None else
               f"{row['library_ms']:.6f} (scaled_dot_product_attention, yardstick)")
        log(f"[timing] flash_attention {tag} shape ({row['shape']}): "
            f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
            f"library_ms={lib} bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
            f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16, "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
            f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound")
    for arch, run in prefill["runs"].items():
        fwd_ms, plain_fwd_ms = time_forward(dev, run)
        B, S = run["batch"]["positions"].shape
        busy_ms, launches, k2_ms = profile_forward(run)
        log(f"[timing] full-width {run['cfg'].name} forward B={B} S={S}: "
            f"{fwd_ms:.3f} ms with K2 ({B * S / fwd_ms * 1e3:.0f} tok/s), "
            f"{plain_fwd_ms:.3f} ms with the plain attention")
        log(f"[profile] full-width {run['cfg'].name} forward (torch.profiler, one "
            f"forward): device busy {busy_ms:.3f} ms ({busy_ms / fwd_ms * 100:.1f}% "
            f"of {fwd_ms:.3f} ms); {launches} kernel launches; flash_attention "
            f"{k2_ms:.3f} ms ({k2_ms / busy_ms * 100:.1f}% of device time)")

    kernels = [{
        "name": "flash_decode", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": DECODE_REPLACES, "launches": serve["launches"],
        "max_abs_err": max_err, "ms": serve_row["ms"],
        "plain_ms": serve_row["plain_ms"], "bound_ms": serve_row["bound_ms"],
        "bound_by": serve_row["bound_by"], "library_ms": serve_row["library_ms"],
        "shape": serve_row["shape"], "long": long_row,
    }, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": prefill["launches"],
        "max_abs_err": flash_err, **{key: rows["smollm"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "hubert": rows["hubert"], "long": rows["long"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
