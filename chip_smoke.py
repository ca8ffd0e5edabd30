#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths at full width with random weights from a seed:
serving smollm-360m and deepseek-moe-16b (decode: K1, and K3 for the
experts), the full-sequence forward of smollm-360m, hubert-xlarge and
deepseek-moe-16b (prefill: K2, and K3), the forward of mamba2-2.7b (K4),
and the forward and decode of recurrentgemma-9b (K5 and K2 at head dim
256; K1). Checks every hand-written kernel on them against its plain torch
version. Phases, each fatal on failure:

1. build   nvcc builds the five kernels from src/repro_torch/kernels/csrc,
           one process a source, all at once, and ptxas reports registers,
           shared memory and spills.
2. kernels each kernel against its plain version on the card, fp32 with
           rtol=atol=1e-4 (the sums run in another order) and bf16 with
           2e-2 (one bf16 rounding of the output): K1 at the decode cases,
           K2 at the cases of the CPU tests and at the smollm-360m, hubert
           and danube prefill shapes and at non-divisible lengths; K3 at
           the CPU tests' shapes, deepseek's decode and prefill shapes and
           ragged ones, contiguous and row-strided; K4 at the CPU tests'
           shapes, a ragged chunk and mamba2-2.7b's full width, against the
           exact recurrence and the model's chunked algebra, both in fp32,
           elementwise (see `ssd_close`); K5 at the CPU tests' shapes,
           ragged S and W, and recurrentgemma-9b's full width (fp32);
           K2 and K1 also at recurrentgemma-9b's local attention (MQA,
           G=16, D=256, window 2048; B=1 S=4096 so that the window masks;
           K1 on a 2048-slot ring past its wrap).
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
8. moe     deepseek-moe-16b (28 layers, 64 experts top-6 + 2 shared),
           drawn in bf16: served as in 3 (K1 = 28 x steps, K3 = 3 x 27 x
           steps); its forward at B=4, S=2048 (28 K2 and 81 K3 launches),
           every K3 call against the plain version, and the logits against
           the plain expert product with the plain run's routing pinned to
           K3's (2e-2 of the largest logit: unpinned, bf16 near ties flip
           the top-6); K3, plain and torch.bmm times at the decode and
           prefill shapes; decode step and forward times with the kernels
           and with their plain versions, and profiles.
9. ssm     mamba2-2.7b (64 layers), fp32 weights and a bf16 copy: its
           forward at B=4, S=2048 (64 K4 launches); every K4 call against
           the exact recurrence; on weights with Mamba-2's published dt and
           A init (`mamba2.published_dt_A`: the specs' init is chaotic at
           this depth, ROADMAP Queue 3), the fp32 forward (K4) against
           teacher-forced decode at every position of a 768-token prompt
           (three chunks, so the state carried between chunks reaches the
           logits) within 2e-2 of the largest logit, and every K4 call of
           the bf16 forward against the recurrence; K4 times and bound,
           forward times with K4 and the chunked scan, a profile, and the
           decode step's time.
10. hybrid recurrentgemma-9b (38 layers: 12 superblocks of rec, rec,
           local attention, and 2 tail rec blocks), drawn in bf16: its
           forward at B=4, S=2048 (12 K2 and 26 K5 launches); every K5
           call against the exact recurrence (fp32 TOL, elementwise) and
           every K2 call against the plain version (with the bf16-P term);
           the logits against the forward with both plain versions on
           `conditioned` weights (2e-2 of the largest logit); 128
           teacher-forced decode steps (K1, 12 launches a step, and the O(1)
           recurrence) with every K1 call against the plain version, and
           their logits against the same decode with the plain attention
           (2e-2 of the largest logit; prefill against decode in bf16 is
           `python -m repro_torch.launch.hybrid_conditioning`, ROADMAP
           Queue 3); K5, its plain version and the model's CPU algorithm (the
           doubling scan) run on the card, K2 against its plain version
           and scaled_dot_product_attention at D=256, K1 on the hybrid's
           rings; forward and decode step times, a profile, peak memory.
Each model's weights are freed before the next model's phase.

Prints a {"kernels": [...]} line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
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
GMM_SOURCE = "src/repro_torch/kernels/csrc/moe_gmm.cu"
GMM_REPLACES = "src/repro/kernels/moe_gmm.py:44"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:75"
RGLRU_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
RGLRU_REPLACES = "src/repro/kernels/rglru_scan.py:52"
KERNELS = ("decode_attention", "flash_attention", "moe_gmm", "ssd_scan",
           "rglru_scan")


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
def plain_ops(**fns):
    """Route each named ops.<name> through the given plain version."""
    from repro_torch.kernels import ops

    saved = {name: getattr(ops, name) for name in fns}
    for name, fn in fns.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def plain_attention():
    """Route the model's decode attention through the plain version."""
    return plain_ops(flash_decode=plain_decode)


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
    ("recurrentgemma ring W2048 G16 D256 w2048", 4, 16, 1, 2048, 256,
     [2047, 2048, 3000, 6000], 2048, ()),
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


def plain_prefill_attention():
    """Route the model's full-sequence attention through the plain version."""
    return plain_ops(flash_attention=plain_flash)


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
    ("recurrentgemma narrow S150 G16 D256 w48", 1, 150, 150, 16, 1, 256, True, 48),
    ("recurrentgemma B4 S2048 G16 D256 w2048", 4, 2048, 2048, 16, 1, 256, True, 2048),
    ("recurrentgemma B1 S4096 G16 D256 w2048", 1, 4096, 4096, 16, 1, 256, True, 2048),
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


def phase_serve(dev, cfg, *, params=None, prompt_len=32, max_new=32, clients=4):
    """Two servers + a gateway answer `clients` requests; returns stats.

    ``params`` (one tree both servers share) replaces each server's own
    seeded initialisation."""
    import torch

    from repro_torch.core.policies import SchedCoop
    from repro_torch.core.threads import UsfRuntime
    from repro_torch.core.topology import Topology
    from repro_torch.kernels import decode_attention, moe_gmm
    from repro_torch.serve.engine import Gateway, InferenceServer

    usf = UsfRuntime(Topology(2, 1), SchedCoop(quantum=0.05))
    try:
        servers = [InferenceServer(f"srv-{c}", cfg, usf, max_batch=4,
                                   max_len=512, seed=0, nice=10, device=dev,
                                   params=params)
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
        moe_gmm.moe_gmm.launches = 0
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
        gmm_launches = moe_gmm.moe_gmm.launches
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
    moe_layers = cfg.n_layers - cfg.first_k_dense if cfg.family == "moe" else 0
    want_gmm = 3 * moe_layers * sum(steps)
    log(f"[serve] {cfg.name}: {clients} clients x {len(servers)} servers served "
        f"{served}; engine steps {steps}; flash_decode launches {launches} (want "
        f"n_layers {cfg.n_layers} x {sum(steps)} = {want}); moe_gmm launches "
        f"{gmm_launches} (want 3 x {moe_layers} MoE layers x {sum(steps)} = "
        f"{want_gmm})")
    if launches != want or gmm_launches != want_gmm:
        raise AssertionError(f"flash_decode launched {launches} times (want "
                             f"{want}), moe_gmm {gmm_launches} (want {want_gmm}): "
                             f"the decode path bypassed a kernel")
    same = sum(r["outputs"]["srv-a"] == r["outputs"]["srv-b"]
               for r in results.values())
    tokens = sum(len(o) for r in results.values() for o in r["outputs"].values())
    lat = sorted(r["latency"] for r in results.values())
    log(f"[serve] wall {wall:.3f} s; {tokens} generated tokens "
        f"({tokens / wall:.1f} tok/s, prefill {prompt_len} x "
        f"{clients * len(servers)} more); request latency s {lat}; "
        f"identical outputs on both servers (same seed) for {same}/{clients}")
    return {"launches": launches, "gmm_launches": gmm_launches,
            "steps": sum(steps), "wall_s": wall, "tok_per_s": tokens / wall,
            "params": servers[0].params}


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

    from repro_torch.launch.inputs import conditioned
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


def time_engine_step(dev, cfg, params, *, B=4, steps=30, plain=None):
    """Host-clock ms of one full-width decode step (synchronised), with
    the kernels and with their plain versions (``plain``, a context
    manager; default the plain attention)."""
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
    with (plain or plain_attention)():
        plain_ms = run()
    return kernel_ms, plain_ms


def profile_steps(dev, cfg, params, *, B=4, steps=3, keys=("flash_decode_kernel",)):
    """torch.profiler over `steps` full-width decode steps (after one
    warm-up step): device-busy ms, kernel launches and the device ms of the
    kernels named by each of ``keys``, each per step."""
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
    busy, launches, mine = device_totals(prof, *keys)
    return busy / steps, launches / steps, [m / steps for m in mine]


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


def logits_gap(got, want):
    """(max abs difference, largest |want|, argmax agreement) of two logits
    tensors, compared a row at a time: at a 256k vocabulary one fp32 copy of
    a B=4, S=2048 forward's logits is 8.4 GB."""
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(w.float().abs().max().item() for w in want)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    return err, scale, agree


def logits_close(got, want, what, tag="prefill"):
    """Logits within 2e-2 of the largest |logit| (see phase_parity b)."""
    import torch

    err, scale, agree = logits_gap(got, want)
    ok = all(bool(torch.isfinite(g).all()) for g in got) and err <= 2e-2 * scale
    log(f"[{tag}] {what}: max_abs_err={err:.3e} (tol 2e-2 of the largest "
        f"|logit|, {scale:.3f}), argmax agreement {agree * 100:.2f}% "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_prefill(dev, *, B=4):
    """The full-width forward of smollm-360m (S=2048) and hubert-xlarge
    (S=1024) through make_prefill_step; returns K2's launches and results."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.inputs import conditioned, make_batch
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
            "by_path": {f"{r['cfg'].name} forward": r["launches"]
                        for r in runs.values()},
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
    if window is None or (causal and window >= S):  # a window that cuts nothing
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qT, kT, vT, is_causal=causal, enable_gqa=True), flush, iters)
    row["bound_ms"], row["bound_by"] = flash_bound(B, S, H, KV, D, causal, window,
                                                   "bfloat16")
    row["shape"] = (f"B={B} S={S} H={H} KV={KV} D={D} {mode}"
                    f"{'' if window is None else f' window {window}'} bf16, "
                    f"model layout; plain = {plain}")
    return row


def time_forward(dev, run, *, iters=5, plain=None):
    """Host-clock ms of one full-width forward (synchronised), with the
    kernels and with their plain versions (``plain``, a context manager;
    default the plain attention)."""
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
    with (plain or plain_prefill_attention)():
        plain_ms = timed()
    return kernel_ms, plain_ms


def profile_forward(run, keys=("flash_fwd_",)):
    """torch.profiler over one full-width forward (after a warm-up one):
    device-busy ms, kernel launches and the device ms of the kernels named
    by each of ``keys``."""
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
    return device_totals(prof, *keys)


def device_totals(prof, *keys):
    """(device-busy ms, kernel launches, [ms of the kernels whose names hold
    each key])."""
    from torch.autograd import DeviceType

    busy = 0.0
    mine = [0.0] * len(keys)
    launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:  # kernels, copies, memsets
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            busy += dev_us
            for i, key in enumerate(keys):
                if key in e.key:
                    mine[i] += dev_us
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += e.count
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy / 1e3, launches, [m / 1e3 for m in mine]


# --------------------------------------------------------------------------- #
# K3 and K4 against their plain versions
# --------------------------------------------------------------------------- #
def plain_gmm(x, w):
    """The plain version of ops.moe_gmm."""
    from repro_torch.kernels import ref

    return ref.moe_gmm_ref(x, w)


def plain_ssd(x, dt, A, Bm, Cm, chunk=256):
    """The model's chunked algebra in place of ops.ssd_scan: the plain
    yardstick of K4 in a forward (the kernel's own plain version, the O(S)
    recurrence ref.ssd_ref, is checked at every call)."""
    from repro_torch.models.mamba2 import ssd_chunked

    return ssd_chunked(x, dt, A, Bm, Cm, chunk)


def plain_moe():
    """Every kernel of the MoE path (K1, K2, K3) as its plain version."""
    return plain_ops(flash_decode=plain_decode, flash_attention=plain_flash,
                     moe_gmm=plain_gmm)


def plain_ssm():
    return plain_ops(ssd_scan=plain_ssd)


GMM_CASES = [
    # name, E, C, D, F
    ("test_kernels 2x64x32x48", 2, 64, 32, 48),
    ("test_kernels 4x100x64x96", 4, 100, 64, 96),
    ("test_kernels 1x128x128x128", 1, 128, 128, 128),
    ("deepseek smoke wg, B2 x C6", 8, 12, 64, 32),
    ("deepseek smoke wd, B2 x C6", 8, 12, 32, 64),
    ("deepseek decode wg C4", 64, 4, 2048, 1408),
    ("deepseek decode wd C4", 64, 4, 1408, 2048),
    ("deepseek prefill wg B4 x C241", 64, 964, 2048, 1408),
    ("deepseek prefill wd B4 x C241", 64, 964, 1408, 2048),
    ("ragged 3x5x37x19 (element loads)", 3, 5, 37, 19),
    ("ragged 3x40x40x24 (C tile edge)", 3, 40, 40, 24),
]


def phase_gmm_kernels(dev) -> float:
    """K3 against its plain version; returns the largest abs error."""
    import torch

    from repro_torch.kernels import moe_gmm

    gen = torch.Generator(device=dev).manual_seed(2468)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).removeprefix("torch.")]
        for name, E, C, D, F in GMM_CASES:
            w = (torch.randn(E, D, F, generator=gen, device=dev) * 0.5).to(dtype)
            buf = (torch.randn(E, 2 * C, D, generator=gen, device=dev) * 0.5).to(dtype)
            layouts = {"[E,C,D]": buf[:, :C].contiguous(),
                       "row-strided view": buf[:, ::2]}
            for lay, x in layouts.items():
                got = moe_gmm.moe_gmm(x, w)
                torch.cuda.synchronize()
                want = plain_gmm(x, w).float()
                err = (got.float() - want).abs().max().item()
                worst = max(worst, err)
                ok = got.shape == want.shape and torch.allclose(
                    got.float(), want, rtol=tol, atol=tol)
                log(f"[kernels] moe_gmm {name:34s} {lay:16s} {str(dtype):14s} "
                    f"max_abs_err={err:.3e} tol={tol:g} (+{tol:g} relative) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"moe_gmm disagrees with its plain "
                                         f"version: {name}, {lay}, {dtype}")
            del w, buf, layouts, got, want
    return worst


SSD_CASES = [
    # name, B, S, H, P, N, Q
    ("test_kernels B1 S64 H2 P16 N8 Q16", 1, 64, 2, 16, 8, 16),
    ("test_kernels B1 S64 H2 P16 N8 Q32", 1, 64, 2, 16, 8, 32),
    ("test_kernels B2 S128 H4 P32 N16 Q16", 2, 128, 4, 32, 16, 16),
    ("test_kernels B2 S128 H4 P32 N16 Q32", 2, 128, 4, 32, 16, 32),
    ("mamba2 smoke B2 S48 H8 P16 N16 Q16", 2, 48, 8, 16, 16, 16),
    ("ragged Q20 B1 S60 H3 P8 N12", 1, 60, 3, 8, 12, 20),
    ("ragged Q100 B2 S200 H4 P64 N128", 2, 200, 4, 64, 128, 100),
    ("mamba2-2.7b B4 S2048 H80 P64 N128 Q256", 4, 2048, 80, 64, 128, 256),
]


def ssd_inputs(gen, dev, dtype, B, S, H, P, N):
    """tests/test_kernels.py's distributions: x, B, C in ``dtype`` as views
    of wider buffers (so the kernel reads them through strides); dt, A fp32."""
    import torch
    import torch.nn.functional as F

    x = torch.randn(B, S, H, 2 * P, generator=gen, device=dev).to(dtype)[..., :P]
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
    bc = (torch.randn(B, S, 2 * N, generator=gen, device=dev) * 0.5).to(dtype)
    return x, dt, A, bc[..., :N], bc[..., N:]


def ssd_close(got, want):
    """(max abs error, worst ratio of the error to its tolerance) of K4's y
    or h against a plain version run in fp32 on the same inputs; within
    tolerance when the ratio is at most 1. Elementwise, the tolerance sums:

    - 1e-4 |want| + 1e-4 max(1, max |want|): the fp32 sum order. K4's
      chunked decays exp(cum_i - cum_j) take cum from a sum of up to Q
      terms dt A (|cum| reaches ~470 at Q = 256 with dt ~ softplus of
      N(0, 1)), the recurrence multiplies one decay a step; an output near
      0 is a difference of terms of the output's size, so its error is a
      fraction of that size and not of itself;
    - when ``got`` is bf16, 2^-8 |want| + 2e-2: one rounding of the
      kernel's fp32 output to bf16 (half an ulp, at most 2^-8 of the
      value), and a flat floor for outputs near 0.
    """
    import torch

    want = want.float()
    bf16 = got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    scale = max(1.0, want.abs().max().item())
    tol = (1e-4 + (2 ** -8 if bf16 else 0.0)) * want.abs() + 1e-4 * scale
    if bf16:
        tol = tol + 2e-2
    return err.max().item(), (err / tol).max().item()


def fp32_ssd(plain, x, dt, A, Bm, Cm, *args):
    """``plain`` (ref.ssd_ref or ssd_chunked) on x, B and C widened to fp32:
    both sum in fp32, and so return y without a bf16 rounding of its own."""
    return plain(x.float(), dt, A, Bm.float(), Cm.float(), *args)


def phase_ssd_kernels(dev) -> float:
    """K4 against its plain version (the exact recurrence) and the model's
    chunked algebra, both run in fp32 (``ssd_close``); returns the largest
    abs error."""
    import torch

    from repro_torch.kernels import ref, ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(1357)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, H, P, N, Q in SSD_CASES:
            x, dt, A, Bm, Cm = ssd_inputs(gen, dev, dtype, B, S, H, P, N)
            y, h = ssd_scan.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
            torch.cuda.synchronize()
            for what, (wy, wh) in (
                    ("ssd_ref", fp32_ssd(ref.ssd_ref, x, dt, A, Bm, Cm)),
                    ("ssd_chunked", fp32_ssd(ssd_chunked, x, dt, A, Bm, Cm, Q))):
                ey, ry = ssd_close(y, wy)
                eh, rh = ssd_close(h, wh)
                worst = max(worst, ey, eh)
                ok = y.shape == wy.shape and h.shape == wh.shape and max(ry, rh) <= 1
                log(f"[kernels] ssd_scan {name:40s} {str(dtype):14s} vs {what:11s} "
                    f"(fp32) y max_abs_err={ey:.3e} at {ry:.3f} of its tolerance, "
                    f"h max_abs_err={eh:.3e} at {rh:.3f} (|y|max "
                    f"{wy.abs().max().item():.3g}, |h|max {wh.abs().max().item():.3g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"ssd_scan disagrees with {what}: {name}, "
                                         f"{dtype}")
            del x, dt, A, Bm, Cm, y, h, wy, wh
    return worst


def gmm_bound(E, C, D, F):
    moved = (E * C * D + E * D * F + E * C * F) * 2
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * E * C * D * F / PEAK_FLOPS["bfloat16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_gmm_shape(dev, flush, E, C, D, F):
    """K3, plain and torch.bmm (the yardstick, never called by the port)
    times at one shape in bf16."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
    w = (torch.randn(E, D, F, generator=gen, device=dev) / D ** 0.5).bfloat16()
    row = {"ms": time_ms(lambda: ops.moe_gmm(x, w), flush),
           "plain_ms": time_ms(lambda: plain_gmm(x, w), flush, 10, warmup=2),
           "library_ms": time_ms(lambda: torch.bmm(x, w), flush)}
    row["bound_ms"], row["bound_by"] = gmm_bound(E, C, D, F)
    row["shape"] = f"E={E} C={C} D={D} F={F} bf16, x [E,C,D] contiguous"
    return row


def ssd_bound(B, S, H, P, N, Q, es):
    """The least time of the scan: x, dt, A, B, C read and y, h written once;
    the chunk algebra's fp32 operations with the causal halves skipped and
    C B^T counted once a chunk (it does not depend on the head)."""
    nc = S // Q
    moved = (2 * B * S * H * P * es + B * S * H * 4 + H * 4 + 2 * B * S * N * es
             + B * H * P * N * 4)
    tri = Q * (Q + 1) // 2
    flops = B * nc * (2 * tri * N + H * (2 * tri * P + 4 * Q * N * P))
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), flops, moved


def time_ssd_shape(dev, flush, B, S, H, P, N, Q):
    """K4, its plain version (the exact recurrence) and the model's chunked
    algebra at one shape: bf16 x, B, C and fp32 dt, A, model layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(B, S, H, P, generator=gen, device=dev).bfloat16()
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
    Bm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5).bfloat16()
    Cm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5).bfloat16()
    row = {"ms": time_ms(lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q), flush, 20),
           "plain_ms": time_ms(lambda: ref.ssd_ref(x, dt, A, Bm, Cm), flush, 2, warmup=1),
           "chunked_ms": time_ms(lambda: plain_ssd(x, dt, A, Bm, Cm, Q), flush, 5,
                                 warmup=1),
           "library_ms": None}
    (row["bound_ms"], row["bound_by"]), flops, moved = ssd_bound(B, S, H, P, N, Q, 2)
    row["shape"] = (f"B={B} S={S} H={H} P={P} N={N} Q={Q}, bf16 x/B/C, fp32 dt/A, "
                    f"model layout; plain = ref.ssd_ref (the O(S) recurrence)")
    row["bound_note"] = (f"{flops / 1e9:.1f} GFLOP at the {PEAK_FLOPS['float32'] / 1e12:.0f}"
                         f" TFLOP/s fp32 rate, {moved / 1e6:.1f} MB at "
                         f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return row


# --------------------------------------------------------------------------- #
# the MoE family: deepseek-moe-16b
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def checked_gmm(tol):
    """Run K3 and, on the same inputs, the plain version at every expert
    product; yields (max abs err, worst excess over tol + tol |want|) per
    call."""
    from repro_torch.kernels import ops

    kernel, found = ops.moe_gmm, []

    def checked(x, w):
        out = kernel(x, w)
        want = plain_gmm(x, w).float()
        d = (out.float() - want).abs()
        found.append((d.max(), (d - tol - tol * want.abs()).max()))
        return out

    ops.moe_gmm = checked
    try:
        yield found
    finally:
        ops.moe_gmm = kernel


@contextlib.contextmanager
def routing(record=None, replay=None):
    """Record each MoE layer's expert choice (top-k of the router), or
    replay recorded choices with gates from the run's own router
    probabilities: the capacity positions follow from the choices."""
    from repro_torch.models import moe

    own, calls = moe.top_k_gates, None if replay is None else iter(replay)

    def top_k_gates(probs, k):
        if calls is not None:
            eidx = next(calls)
            gates = probs.gather(-1, eidx)
            return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), eidx
        gates, eidx = own(probs, k)
        if record is not None:
            record.append(eidx)
        return gates, eidx

    moe.top_k_gates = top_k_gates
    try:
        yield
    finally:
        moe.top_k_gates = own


def gb(nbytes) -> str:
    return f"{nbytes / 1e9:.1f} GB"


def phase_moe(dev, flush, *, B=4, S=2048):
    """deepseek-moe-16b at full width: served (K1, K3), its forward (K2,
    K3) with per-call and pinned-routing logits checks, and timings."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import flash_attention, moe_gmm
    from repro_torch.launch.inputs import conditioned, make_batch
    from repro_torch.models.base import init_tree, param_count
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step

    cfg = get_arch("deepseek_moe_16b")
    model, sharder = build_model(cfg), Sharder(None)
    n_moe = cfg.n_layers - cfg.first_k_dense
    log(f"[moe] config {cfg.name}: {cfg.n_layers}L ({cfg.first_k_dense} dense) "
        f"d_model {cfg.d_model} H {cfg.n_heads} KV {cfg.n_kv_heads} hd {cfg.hd}, "
        f"{cfg.n_experts} routed experts top-{cfg.top_k} + {cfg.n_shared_experts} "
        f"shared, expert d_ff {cfg.expert_d_ff}, vocab {cfg.vocab}")
    torch.cuda.reset_peak_memory_stats()
    # drawn in the compute dtype (the router, fp32 by its spec, stays fp32):
    # fp32 weights and a bf16 copy would not fit the card's 80 GB
    params = model.compute_params(init_tree(
        torch.Generator(device=dev).manual_seed(0), model.param_specs(),
        cfg.compute_dtype, dev))
    torch.cuda.synchronize()
    log(f"[moe] {cfg.name}: {param_count(model.param_specs()) / 1e9:.2f} B params "
        f"drawn in {cfg.compute_dtype} (router fp32): "
        f"{gb(torch.cuda.memory_allocated())} on the card, peak "
        f"{gb(torch.cuda.max_memory_allocated())}")

    serve = phase_serve(dev, cfg, params=params)
    serve.pop("params")

    # the forward through make_prefill_step
    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev,
                       with_labels=False)
    step = make_prefill_step(model, sharder)
    torch.cuda.synchronize()
    flash_attention.flash_attention_fwd.launches = 0
    moe_gmm.moe_gmm.launches = 0
    logits = step(params, batch)
    torch.cuda.synchronize()
    k2 = flash_attention.flash_attention_fwd.launches
    k3 = moe_gmm.moe_gmm.launches
    finite = bool(torch.isfinite(logits).all())
    ok = (tuple(logits.shape) == (B, S, cfg.vocab) and finite
          and k2 == cfg.n_layers and k3 == 3 * n_moe)
    log(f"[moe] forward {cfg.name} B={B} S={S} {cfg.compute_dtype}: logits "
        f"{tuple(logits.shape)}, finite {finite}; flash_attention launches {k2} "
        f"(want {cfg.n_layers}), moe_gmm launches {k3} (want 3 x {n_moe}) "
        f"{'ok' if ok else 'FAIL'}")
    del logits

    # a. every K3 call of the forward against the plain version
    with checked_gmm(TOL["bfloat16"]) as found:
        step(params, batch)
    gmm_err = max(e.item() for e, _ in found)
    good = len(found) == 3 * n_moe and max(x.item() for _, x in found) <= 0
    log(f"[moe] a. {cfg.name} bf16 K3 calls of the forward against the plain "
        f"version on the model's inputs: {len(found)} calls, max_abs_err="
        f"{gmm_err:.3e} (tol 2e-2 + 2e-2 relative) {'ok' if good else 'FAIL'}")
    ok &= good

    # b. logits, K3 vs the plain expert product, routing pinned
    cond = conditioned(cfg, params)
    chosen, unpinned = [], []
    with routing(record=chosen):
        got = step(cond, batch)
    with plain_ops(moe_gmm=plain_gmm):
        with routing(record=unpinned):
            step(cond, batch)
        with routing(replay=chosen):
            want = step(cond, batch)
    flips = torch.zeros(B, S, dtype=torch.bool, device=dev)
    for a, b in zip(chosen, unpinned):
        flips |= (a.sort(-1).values != b.sort(-1).values).any(-1)
    log(f"[moe] b. unpinned, the top-{cfg.top_k} choice of the plain run differs "
        f"from K3's at some layer for {flips.float().mean().item() * 100:.3f}% of "
        f"the {B * S} tokens (bf16 router inputs; a last-bit difference flips a "
        f"near tie)")
    ok &= logits_close(got, want, f"b. {cfg.name} bf16 logits of all {B * S} "
                       f"tokens, conditioned weights, K3 vs plain expert product "
                       f"with the plain run's routing pinned to K3's", "moe")
    del got, want, cond, chosen, unpinned
    if not ok:
        raise AssertionError("the MoE path failed its checks")

    # timings
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    rows = {"decode": time_gmm_shape(dev, flush, E, 4, D, Fd),
            "prefill": time_gmm_shape(dev, flush, E, B * 241, D, Fd)}
    for tag, row in rows.items():
        log(f"[timing] moe_gmm {tag} shape ({row['shape']}): kernel_ms="
            f"{row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms="
            f"{row['library_ms']:.6f} (torch.bmm, yardstick) bound_ms="
            f"{row['bound_ms']:.6f} ({row['bound_by']}); "
            f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound")
    step_ms, plain_step_ms = time_engine_step(dev, cfg, params, steps=15,
                                              plain=plain_moe)
    log(f"[timing] full-width {cfg.name} decode step B=4: {step_ms:.3f} ms with "
        f"K1 and K3, {plain_step_ms:.3f} ms with their plain versions; engine "
        f"{serve['tok_per_s']:.1f} generated tok/s over {serve['steps']} steps in "
        f"{serve['wall_s']:.3f} s")
    busy, launches, (k1_ms, k3_ms) = profile_steps(
        dev, cfg, params, keys=("flash_decode_kernel", "gmm_"))
    log(f"[profile] full-width {cfg.name} decode step B=4 (torch.profiler, 3 "
        f"steps): device busy {busy:.3f} ms a step ({busy / step_ms * 100:.1f}% of "
        f"the {step_ms:.3f} ms step, idle {100 - busy / step_ms * 100:.1f}%); "
        f"{launches:.0f} kernel launches a step; moe_gmm {k3_ms:.3f} ms a step "
        f"({k3_ms / busy * 100:.1f}% of device time), flash_decode {k1_ms:.3f} ms "
        f"({k1_ms / busy * 100:.1f}%)")
    run = {"model": model, "params": params, "batch": batch}
    fwd_ms, plain_fwd_ms = time_forward(dev, run, iters=3, plain=plain_moe)
    busy, launches, (k2_ms, k3_ms) = profile_forward(run, keys=("flash_fwd_", "gmm_"))
    log(f"[timing] full-width {cfg.name} forward B={B} S={S}: {fwd_ms:.3f} ms with "
        f"K2 and K3 ({B * S / fwd_ms * 1e3:.0f} tok/s), {plain_fwd_ms:.3f} ms with "
        f"their plain versions")
    log(f"[profile] full-width {cfg.name} forward (torch.profiler, one forward): "
        f"device busy {busy:.3f} ms ({busy / fwd_ms * 100:.1f}% of {fwd_ms:.3f} ms); "
        f"{launches} kernel launches; moe_gmm {k3_ms:.3f} ms ({k3_ms / busy * 100:.1f}"
        f"% of device time), flash_attention {k2_ms:.3f} ms "
        f"({k2_ms / busy * 100:.1f}%)")
    log(f"[moe] peak device memory of the {cfg.name} phase: "
        f"{gb(torch.cuda.max_memory_allocated())}")
    return {"serve_k1": serve["launches"], "serve_k3": serve["gmm_launches"],
            "fwd_k2": k2, "fwd_k3": k3, "gmm_err": gmm_err, "rows": rows}


# --------------------------------------------------------------------------- #
# the SSM family: mamba2-2.7b
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def checked_ssd():
    """Run K4 and, on the same inputs, its plain version (the exact
    recurrence, in fp32) at every scan; yields (y err, y's ratio to its
    tolerance, h err, h's ratio) per call, by ``ssd_close``."""
    from repro_torch.kernels import ops, ref

    kernel, found = ops.ssd_scan, []

    def checked(x, dt, A, Bm, Cm, chunk=256):
        y, h = kernel(x, dt, A, Bm, Cm, chunk=chunk)
        wy, wh = fp32_ssd(ref.ssd_ref, x, dt, A, Bm, Cm)
        found.append((*ssd_close(y, wy), *ssd_close(h, wh)))
        return y, h

    ops.ssd_scan = checked
    try:
        yield found
    finally:
        ops.ssd_scan = kernel


def ssm_calls(found, what):
    """Log the per-call K4 results of ``checked_ssd``; True if all held."""
    good = all(max(c[1], c[3]) <= 1 for c in found)
    log(f"[ssm] {what}: {len(found)} calls, y max_abs_err="
        f"{max(c[0] for c in found):.3e} at {max(c[1] for c in found):.3f} of its "
        f"tolerance, state max_abs_err={max(c[2] for c in found):.3e} at "
        f"{max(c[3] for c in found):.3f} (see ssd_close) {'ok' if good else 'FAIL'}")
    return good


def phase_ssm(dev, flush, *, B=4, S=2048, prompt=768):
    """mamba2-2.7b at full width: its forward (K4) with per-call checks,
    the fp32 forward against teacher-forced decode over three chunks, and
    timings."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.inputs import make_batch
    from repro_torch.models.base import init_tree, param_count
    from repro_torch.models.mamba2 import published_dt_A
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step

    cfg = get_arch("mamba2_2_7b")
    model, sharder = build_model(cfg), Sharder(None)
    torch.cuda.reset_peak_memory_stats()
    params32 = init_tree(torch.Generator(device=dev).manual_seed(0),
                         model.param_specs(), cfg.param_dtype, dev)
    params = model.compute_params(params32)
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    log(f"[ssm] config {cfg.name}: {cfg.n_layers}L d_model {cfg.d_model}, {H} SSM "
        f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
        f"vocab {cfg.vocab}; {param_count(model.param_specs()) / 1e9:.2f} B params, "
        f"{cfg.param_dtype} params and a {cfg.compute_dtype} compute copy: "
        f"{gb(torch.cuda.memory_allocated())} on the card")

    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev,
                       with_labels=False)
    step = make_prefill_step(model, sharder)
    torch.cuda.synchronize()
    ssd_scan.ssd_scan.launches = 0
    logits = step(params, batch)
    torch.cuda.synchronize()
    k4 = ssd_scan.ssd_scan.launches
    finite = bool(torch.isfinite(logits).all())
    ok = tuple(logits.shape) == (B, S, cfg.vocab) and finite and k4 == cfg.n_layers
    log(f"[ssm] forward {cfg.name} B={B} S={S} {cfg.compute_dtype}: logits "
        f"{tuple(logits.shape)}, finite {finite}; ssd_scan launches {k4} (want "
        f"n_layers {cfg.n_layers}) {'ok' if ok else 'FAIL'}")
    del logits

    # a. every K4 call of the forward against the exact recurrence
    with checked_ssd() as found:
        step(params, batch)
    ssd_err = max(max(c[0], c[2]) for c in found)
    ok &= ssm_calls(found, f"a. {cfg.name} K4 calls of the bf16 forward against "
                    f"its plain version (the exact recurrence, fp32) on the "
                    f"model's inputs") and len(found) == cfg.n_layers

    # b. the fp32 forward (K4) against teacher-forced decode (no kernel)
    # over `prompt` tokens, several chunks, so that the state K4 carries
    # across chunk boundaries reaches the logits; on Mamba-2's published
    # dt and A init (the specs' init is chaotic at this depth, ROADMAP
    # Queue 3: `python -m repro_torch.launch.ssm_conditioning`)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32)
    cond32 = published_dt_A(params32, torch.Generator(device=dev).manual_seed(5))
    toks = batch["tokens"][:, :prompt]
    short = {"tokens": toks, "positions": batch["positions"][:, :prompt]}
    t0 = time.perf_counter()
    pre = make_prefill_step(model32, sharder)(cond32, short)
    with torch.inference_mode():
        dec = decode_run(model32, cond32, fresh_cache(cfg32, B, prompt, dev),
                         toks.t().contiguous(), sharder).transpose(0, 1)
    ok &= logits_close(pre, dec, f"b. {cfg.name} fp32 logits at all {prompt} "
                       f"positions ({prompt // cfg.ssm_chunk} chunks of "
                       f"{cfg.ssm_chunk}), forward (K4) vs teacher-forced decode "
                       f"(no kernel), Mamba-2's dt and A init; "
                       f"{time.perf_counter() - t0:.1f} s", "ssm")
    del pre, dec

    # c. every K4 call of the bf16 forward on the same init
    cond = model.compute_params(cond32)
    with checked_ssd() as found:
        step(cond, batch)
    ok &= ssm_calls(found, f"c. {cfg.name} K4 calls of the bf16 forward on "
                    f"Mamba-2's dt and A init against the exact recurrence "
                    f"(fp32)") and len(found) == cfg.n_layers
    del cond, cond32, params32

    row = time_ssd_shape(dev, flush, B, S, H, cfg.ssm_head_dim, cfg.ssm_state,
                         cfg.ssm_chunk)
    log(f"[timing] ssd_scan ({row['shape']}): kernel_ms={row['ms']:.6f} plain_ms="
        f"{row['plain_ms']:.6f} chunked_ms={row['chunked_ms']:.6f} (the model's "
        f"chunked algebra) library_ms=n/a (no single PyTorch call) bound_ms="
        f"{row['bound_ms']:.6f} ({row['bound_by']}: {row['bound_note']}); "
        f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound")
    run = {"model": model, "params": params, "batch": batch}
    fwd_ms, plain_fwd_ms = time_forward(dev, run, iters=3, plain=plain_ssm)
    busy, launches, (k4_ms,) = profile_forward(run, keys=("ssd_fwd",))
    log(f"[timing] full-width {cfg.name} forward B={B} S={S}: {fwd_ms:.3f} ms with "
        f"K4 ({B * S / fwd_ms * 1e3:.0f} tok/s), {plain_fwd_ms:.3f} ms with the "
        f"chunked scan")
    log(f"[profile] full-width {cfg.name} forward (torch.profiler, one forward): "
        f"device busy {busy:.3f} ms ({busy / fwd_ms * 100:.1f}% of {fwd_ms:.3f} ms); "
        f"{launches} kernel launches; ssd_scan {k4_ms:.3f} ms "
        f"({k4_ms / busy * 100:.1f}% of device time)")
    step_ms, _ = time_engine_step(dev, cfg, params, steps=15,
                                  plain=contextlib.nullcontext)
    busy, launches, _ = profile_steps(dev, cfg, params, keys=())
    log(f"[timing] full-width {cfg.name} decode step B=4 (no kernel on this "
        f"path): {step_ms:.3f} ms; device busy {busy:.3f} ms a step "
        f"({busy / step_ms * 100:.1f}%), {launches:.0f} kernel launches a step")
    log(f"[ssm] peak device memory of the {cfg.name} phase: "
        f"{gb(torch.cuda.max_memory_allocated())}")
    if not ok:
        raise AssertionError("the SSM path failed its checks")
    return {"fwd_k4": k4, "ssd_err": ssd_err, "row": row}


# --------------------------------------------------------------------------- #
# K5 against its plain version, and the hybrid family: recurrentgemma-9b
# --------------------------------------------------------------------------- #
RGLRU_CASES = [
    # name, B, S, W, dtypes
    ("test_kernels B1 S64 W128", 1, 64, 128, ("float32", "bfloat16")),
    ("test_kernels B2 S128 W256", 2, 128, 256, ("float32", "bfloat16")),
    ("test_kernels B1 S32 W128", 1, 32, 128, ("float32", "bfloat16")),
    ("ragged B2 S37 W100", 2, 37, 100, ("float32", "bfloat16")),
    ("ragged B1 S300 W129", 1, 300, 129, ("float32", "bfloat16")),
    ("ragged B3 S1 W7", 3, 1, 7, ("float32", "bfloat16")),
    # the model's a and b are fp32
    ("recurrentgemma-9b B4 S2048 W4096", 4, 2048, 4096, ("float32",)),
]


def rglru_inputs(gen, dev, dtype, B, S, W):
    """tests/test_kernels.py's distributions: a = sigmoid(N(0,1)) and
    b = 0.1 N(0,1) in ``dtype`` as views of one wider buffer (so the kernel
    reads them through strides); h0 = N(0,1) fp32."""
    import torch

    ab = torch.randn(B, S, 2 * W, generator=gen, device=dev)
    ab[..., :W].sigmoid_()
    ab[..., W:].mul_(0.1)
    ab = ab.to(dtype)
    h0 = torch.randn(B, W, generator=gen, device=dev)
    return ab[..., :W], ab[..., W:], h0


def rglru_close(y, h, wy, wh, tol):
    """(max abs error, within tolerance) of K5's y and h against its plain
    version, elementwise at rtol = atol = tol."""
    import torch

    err = max((y.float() - wy.float()).abs().max().item(), (h - wh).abs().max().item())
    ok = (y.shape == wy.shape and y.dtype == wy.dtype
          and torch.allclose(y.float(), wy.float(), rtol=tol, atol=tol)
          and torch.allclose(h, wh, rtol=TOL["float32"], atol=TOL["float32"]))
    return err, ok


def phase_rglru_kernels(dev) -> dict:
    """K5 against its plain version (the exact recurrence); returns the
    largest abs error of the fp32 and of the bf16 cases."""
    import torch

    from repro_torch.kernels import ref, rglru_scan

    gen = torch.Generator(device=dev).manual_seed(9753)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, B, S, W, dtypes in RGLRU_CASES:
        for dname in dtypes:
            tol = TOL[dname]
            a, b, h0 = rglru_inputs(gen, dev, getattr(torch, dname), B, S, W)
            y, h = rglru_scan.rglru_scan(a, b, h0)
            torch.cuda.synchronize()
            err, ok = rglru_close(y, h, *ref.rglru_ref(a, b, h0), tol)
            worst[dname] = max(worst[dname], err)
            log(f"[kernels] rglru_scan {name:34s} {dname:9s} max_abs_err={err:.3e} "
                f"tol={tol:g} (+{tol:g} relative; h at fp32 tol) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"rglru_scan disagrees with its plain version: "
                                     f"{name}, {dname}")
            del a, b, h0, y, h
    return worst


def plain_hybrid():
    """Every kernel of the hybrid path (K1, K2, K5) as its plain version."""
    from repro_torch.kernels import ref

    return plain_ops(flash_decode=plain_decode, flash_attention=plain_flash,
                     rglru=ref.rglru_ref)


@contextlib.contextmanager
def checked_rglru():
    """Run K5 and, on the same inputs, its plain version at every scan;
    yields (max abs err, within fp32 TOL) per call, by ``rglru_close``."""
    from repro_torch.kernels import ops, ref

    kernel, found = ops.rglru, []

    def checked(a, b, h0):
        y, h = kernel(a, b, h0)
        found.append(rglru_close(y, h, *ref.rglru_ref(a, b, h0), TOL["float32"]))
        return y, h

    ops.rglru = checked
    try:
        yield found
    finally:
        ops.rglru = kernel


def rglru_bound(B, S, W, es):
    """The least time of the scan: a and b read and y written once (``es``
    bytes an element), h0 read and h written once in fp32; one FMA an
    element at the fp32 rate."""
    moved = 3 * B * S * W * es + 2 * B * W * 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * B * S * W / PEAK_FLOPS["float32"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), moved


def time_rglru_shape(dev, flush, B, S, W):
    """K5, its plain version (the step recurrence) and the model's CPU
    algorithm (the doubling scan) run on the card, at one shape in fp32 (the
    model's a and b). No single PyTorch call computes the scan."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models.rglru import associative_scan

    a, b, h0 = rglru_inputs(torch.Generator(device=dev).manual_seed(10), dev,
                            torch.float32, B, S, W)
    a, b = a.contiguous(), b.contiguous()
    row = {"ms": time_ms(lambda: ops.rglru(a, b, h0), flush),
           "plain_ms": time_ms(lambda: ref.rglru_ref(a, b, h0), flush, 5, warmup=1),
           "scan_ms": time_ms(lambda: associative_scan(a, b), flush, 5, warmup=1),
           "library_ms": None}
    (row["bound_ms"], row["bound_by"]), moved = rglru_bound(B, S, W, 4)
    row["shape"] = (f"B={B} S={S} W={W} fp32 a/b/y, contiguous; plain = "
                    f"ref.rglru_ref (the step recurrence)")
    row["bound_note"] = f"{moved / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s"
    return row


def phase_hybrid(dev, flush, *, B=4, S=2048, prompt=128):
    """recurrentgemma-9b at full width: its forward (K2 at D=256, K5) and
    its teacher-forced decode (K1), each kernel call against its plain
    version and the logits of both paths against the same path with the
    plain versions; timings."""
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import decode_attention, flash_attention, rglru_scan
    from repro_torch.launch.inputs import conditioned, make_batch
    from repro_torch.models.base import init_tree, param_count
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step

    cfg = get_arch("recurrentgemma_9b")
    model, sharder = build_model(cfg), Sharder(None)
    n_attn = cfg.n_layers // 3
    n_rec = cfg.n_layers - n_attn
    log(f"[hybrid] config {cfg.name}: {cfg.n_layers}L ({n_attn} superblocks of rec, "
        f"rec, local attention + {n_rec - 2 * n_attn} tail rec) d_model "
        f"{cfg.d_model} H {cfg.n_heads} KV {cfg.n_kv_heads} hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, lru_width {cfg.lru_width}, local window {cfg.local_window}, "
        f"vocab {cfg.vocab}")
    torch.cuda.reset_peak_memory_stats()
    # drawn in the compute dtype (lam and the norms are read in fp32):
    # fp32 weights and a bf16 copy would need ~58 GB
    params = model.compute_params(init_tree(
        torch.Generator(device=dev).manual_seed(0), model.param_specs(),
        cfg.compute_dtype, dev))
    torch.cuda.synchronize()
    log(f"[hybrid] {cfg.name}: {param_count(model.param_specs()) / 1e9:.2f} B params "
        f"drawn in {cfg.compute_dtype}: {gb(torch.cuda.memory_allocated())} on the "
        f"card, peak {gb(torch.cuda.max_memory_allocated())}")

    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev,
                       with_labels=False)
    step = make_prefill_step(model, sharder)
    torch.cuda.synchronize()
    flash_attention.flash_attention_fwd.launches = 0
    rglru_scan.rglru_scan.launches = 0
    logits = step(params, batch)
    torch.cuda.synchronize()
    k2 = flash_attention.flash_attention_fwd.launches
    k5 = rglru_scan.rglru_scan.launches
    finite = all(bool(torch.isfinite(row).all()) for row in logits)
    ok = (tuple(logits.shape) == (B, S, cfg.vocab) and finite
          and k2 == n_attn and k5 == n_rec)
    log(f"[hybrid] forward {cfg.name} B={B} S={S} {cfg.compute_dtype}: logits "
        f"{tuple(logits.shape)}, finite {finite}; flash_attention launches {k2} "
        f"(want {n_attn}), rglru_scan launches {k5} (want {n_rec}) "
        f"{'ok' if ok else 'FAIL'}")
    del logits

    # a. every K5 and K2 call of the forward against its plain version
    with checked_rglru() as found5, \
            checked_prefill_attention(TOL["bfloat16"]) as found2:
        step(params, batch)
    rglru_err = max(e for e, _ in found5)
    good = len(found5) == n_rec and all(held for _, held in found5)
    log(f"[hybrid] a. {cfg.name} K5 calls of the forward against the exact "
        f"recurrence on the model's fp32 a and b: {len(found5)} calls, "
        f"max_abs_err={rglru_err:.3e} (fp32 tol {TOL['float32']:g} + "
        f"{TOL['float32']:g} relative) {'ok' if good else 'FAIL'}")
    ok &= good
    attn_err = max(e.item() for e, _ in found2)
    good = len(found2) == n_attn and max(x.item() for _, x in found2) <= 0
    log(f"[hybrid] a. {cfg.name} {cfg.compute_dtype} K2 calls (D={cfg.hd}, G="
        f"{cfg.n_heads // cfg.n_kv_heads}, window {cfg.local_window}) against the plain version on the model's inputs: "
        f"{len(found2)} calls, max_abs_err={attn_err:.3e} (tol 2e-2 + 2e-2 "
        f"relative + 2^-8 sum_j p_j |v_j|) {'ok' if good else 'FAIL'}")
    ok &= good
    del found5, found2

    # b. logits with K2 and K5 against both plain versions, conditioned weights
    cond = conditioned(cfg, params)
    got = step(cond, batch)
    with plain_hybrid():
        want = step(cond, batch)
    ok &= logits_close(got, want, f"b. {cfg.name} {cfg.compute_dtype} logits of "
                       f"all {B * S} tokens, conditioned weights, K2 and K5 vs their plain "
                       f"versions", "hybrid")
    del got, want

    # c. teacher-forced decode (K1, the O(1) recurrence) of a `prompt`-token
    # prompt: every K1 call against the plain version on the same inputs;
    # d. its logits against the same decode with the plain attention, each
    # through its own cache (phase 4's checks). Prefill against decode in
    # bf16 is `python -m repro_torch.launch.hybrid_conditioning`: the
    # reference model's own two paths differ by more than 2e-2 of the
    # largest logit in bf16 (ROADMAP Queue 3).
    toks = batch["tokens"][:, :prompt].t().contiguous()
    decode_attention.flash_decode.launches = 0
    with torch.inference_mode():
        with checked_attention(TOL["bfloat16"]) as found1:
            got = decode_run(model, cond, fresh_cache(cfg, B, prompt, dev), toks,
                             sharder)
        k1 = decode_attention.flash_decode.launches
        with plain_attention():
            want = decode_run(model, cond, fresh_cache(cfg, B, prompt, dev), toks,
                              sharder)
    dec_err = max(e.item() for e, _ in found1)
    good = (len(found1) == k1 == n_attn * prompt
            and max(x.item() for _, x in found1) <= 0)
    log(f"[hybrid] c. {cfg.name} {cfg.compute_dtype} K1 calls (D={cfg.hd}, G="
        f"{cfg.n_heads // cfg.n_kv_heads}) of {prompt} teacher-forced decode steps "
        f"x B={B} against the plain version on the model's inputs: {len(found1)} "
        f"calls, {k1} launches (want {n_attn} x {prompt}), max_abs_err="
        f"{dec_err:.3e} (tol 2e-2 + 2e-2 relative) {'ok' if good else 'FAIL'}")
    ok &= good
    ok &= logits_close(got, want, f"d. {cfg.name} {cfg.compute_dtype} decode logits "
                       f"at all {prompt} positions, conditioned weights, K1 vs the "
                       f"plain attention, each through its own cache", "hybrid")
    del cond, got, want, found1
    if not ok:
        raise AssertionError("the hybrid path failed its checks")

    # timings
    rows = {"rglru": time_rglru_shape(dev, flush, B, S, cfg.lru_width),
            "flash": time_flash_shape(dev, flush, B, S, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.hd, True, window=cfg.local_window),
            "decode_prompt": time_decode_shape(dev, flush, B, cfg.n_heads,
                                               cfg.n_kv_heads, prompt, cfg.hd),
            "decode_ring": time_decode_shape(dev, flush, B, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.local_window,
                                             cfg.hd)}
    r = rows["rglru"]
    log(f"[timing] rglru_scan ({r['shape']}): kernel_ms={r['ms']:.6f} plain_ms="
        f"{r['plain_ms']:.6f} scan_ms={r['scan_ms']:.6f} (the model's doubling "
        f"scan) library_ms=n/a (no single PyTorch call) bound_ms="
        f"{r['bound_ms']:.6f} ({r['bound_by']}: {r['bound_note']}); "
        f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound")
    r = rows["flash"]
    lib = ("n/a" if r["library_ms"] is None else f"{r['library_ms']:.6f} "
           f"(scaled_dot_product_attention, causal: the window cuts nothing at "
           f"S={S}; yardstick)")
    log(f"[timing] flash_attention recurrentgemma shape ({r['shape']}): kernel_ms="
        f"{r['ms']:.6f} plain_ms={r['plain_ms']:.6f} library_ms={lib} bound_ms="
        f"{r['bound_ms']:.6f} ({r['bound_by']}); "
        f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound")
    for tag in ("decode_prompt", "decode_ring"):
        r = rows[tag]
        log(f"[timing] flash_decode recurrentgemma {tag} ({r['shape']}): kernel_ms="
            f"{r['ms']:.6f} plain_ms={r['plain_ms']:.6f} library_ms="
            f"{r['library_ms']:.6f} (scaled_dot_product_attention, yardstick) "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']})")
    run = {"model": model, "params": params, "batch": batch}
    fwd_ms, plain_fwd_ms = time_forward(dev, run, iters=3, plain=plain_hybrid)
    busy, launches, (k2_ms, k5_ms) = profile_forward(run, keys=("flash_fwd_",
                                                                "rglru_fwd"))
    log(f"[timing] full-width {cfg.name} forward B={B} S={S}: {fwd_ms:.3f} ms with "
        f"K2 and K5 ({B * S / fwd_ms * 1e3:.0f} tok/s), {plain_fwd_ms:.3f} ms with "
        f"their plain versions")
    log(f"[profile] full-width {cfg.name} forward (torch.profiler, one forward): "
        f"device busy {busy:.3f} ms ({busy / fwd_ms * 100:.1f}% of {fwd_ms:.3f} ms); "
        f"{launches} kernel launches; rglru_scan {k5_ms:.3f} ms ({k5_ms / busy * 100:.1f}"
        f"% of device time), flash_attention {k2_ms:.3f} ms "
        f"({k2_ms / busy * 100:.1f}%)")
    step_ms, plain_step_ms = time_engine_step(dev, cfg, params, B=B, steps=15)
    busy, launches, (k1_ms,) = profile_steps(dev, cfg, params, B=B)
    log(f"[timing] full-width {cfg.name} decode step B={B} (cache max_len 512): "
        f"{step_ms:.3f} ms with K1, {plain_step_ms:.3f} ms with the plain "
        f"attention; device busy {busy:.3f} ms a step ({busy / step_ms * 100:.1f}%, "
        f"idle {100 - busy / step_ms * 100:.1f}%), {launches:.0f} kernel launches a "
        f"step, flash_decode {k1_ms:.3f} ms ({k1_ms / busy * 100:.1f}% of device "
        f"time)")
    log(f"[hybrid] peak device memory of the {cfg.name} phase: "
        f"{gb(torch.cuda.max_memory_allocated())}")
    return {"fwd_k2": k2, "fwd_k5": k5, "dec_k1": k1, "rglru_err": rglru_err,
            "attn_err": attn_err, "rows": rows}


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

    t_start = time.perf_counter()
    phase_build()
    max_err = phase_kernels(dev)
    flash_err = phase_flash_kernels(dev)
    gmm_err = phase_gmm_kernels(dev)
    ssd_err = phase_ssd_kernels(dev)
    rglru_err = phase_rglru_kernels(dev)
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
    busy_ms, launches, (k1_ms,) = profile_steps(dev, cfg, params)
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
        busy_ms, launches, (k2_ms,) = profile_forward(run)
        log(f"[timing] full-width {run['cfg'].name} forward B={B} S={S}: "
            f"{fwd_ms:.3f} ms with K2 ({B * S / fwd_ms * 1e3:.0f} tok/s), "
            f"{plain_fwd_ms:.3f} ms with the plain attention")
        log(f"[profile] full-width {run['cfg'].name} forward (torch.profiler, one "
            f"forward): device busy {busy_ms:.3f} ms ({busy_ms / fwd_ms * 100:.1f}% "
            f"of {fwd_ms:.3f} ms); {launches} kernel launches; flash_attention "
            f"{k2_ms:.3f} ms ({k2_ms / busy_ms * 100:.1f}% of device time)")

    del prefill["runs"], run
    log(f"[memory] peak device memory of the smollm-360m and hubert-xlarge phases: "
        f"{gb(torch.cuda.max_memory_allocated())}")
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(dev, flush)
    gc.collect()
    torch.cuda.empty_cache()
    ssm = phase_ssm(dev, flush)
    gc.collect()
    torch.cuda.empty_cache()
    hybrid = phase_hybrid(dev, flush)
    log(f"[env] whole run {time.perf_counter() - t_start:.1f} s")

    k1_paths = {"smollm-360m serve": serve["launches"],
                "deepseek-moe-16b serve": moe["serve_k1"],
                "recurrentgemma-9b decode": hybrid["dec_k1"]}
    k2_paths = {**prefill["by_path"], "deepseek-moe-16b forward": moe["fwd_k2"],
                "recurrentgemma-9b forward": hybrid["fwd_k2"]}
    k3_paths = {"deepseek-moe-16b serve": moe["serve_k3"],
                "deepseek-moe-16b forward": moe["fwd_k3"]}
    kernels = [{
        "name": "flash_decode", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": DECODE_REPLACES, "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": max_err, "ms": serve_row["ms"],
        "plain_ms": serve_row["plain_ms"], "bound_ms": serve_row["bound_ms"],
        "bound_by": serve_row["bound_by"], "library_ms": serve_row["library_ms"],
        "shape": serve_row["shape"], "long": long_row,
        "recurrentgemma_prompt": hybrid["rows"]["decode_prompt"],
        "recurrentgemma_ring": hybrid["rows"]["decode_ring"],
    }, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": flash_err, **{key: rows["smollm"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "hubert": rows["hubert"], "long": rows["long"],
        "recurrentgemma": hybrid["rows"]["flash"],
    }, {
        "name": "moe_gmm", "route": "cuda", "source": GMM_SOURCE,
        "replaces": GMM_REPLACES, "launches": sum(k3_paths.values()),
        "launches_by_path": k3_paths, "max_abs_err": max(gmm_err, moe["gmm_err"]),
        **{key: moe["rows"]["decode"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "prefill": moe["rows"]["prefill"],
    }, {
        "name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "launches": ssm["fwd_k4"],
        "launches_by_path": {"mamba2-2.7b forward": ssm["fwd_k4"]},
        "max_abs_err": max(ssd_err, ssm["ssd_err"]),
        **{key: ssm["row"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "chunked_ms")},
    }, {
        "name": "rglru_scan", "route": "cuda", "source": RGLRU_SOURCE,
        "replaces": RGLRU_REPLACES, "launches": hybrid["fwd_k5"],
        "launches_by_path": {"recurrentgemma-9b forward": hybrid["fwd_k5"]},
        "max_abs_err": max(rglru_err["float32"], hybrid["rglru_err"]),
        "max_abs_err_bf16": rglru_err["bfloat16"],
        **{key: hybrid["rows"]["rglru"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "scan_ms")},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
