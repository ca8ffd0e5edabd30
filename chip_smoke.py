#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths at full width with random weights from a seed:
serving smollm-360m (in one process, and in two server processes under
the node broker), deepseek-moe-16b, mamba2-2.7b and recurrentgemma-9b
(decode: K1, K3 for the experts, no kernel in mamba2's step), the
full-sequence forward of smollm-360m, hubert-xlarge and deepseek-moe-16b
(prefill: K2, and K3), the forward of mamba2-2.7b (K4), the forward and
decode of recurrentgemma-9b (K5 and K2 at head dim 256; K1), and the
forward and decode of qwen2-vl-7b on patch embeddings with M-RoPE (K2 and
K1 at G=7). Checks every hand-written kernel on them against its plain
torch version. Phases, each fatal on failure:

1. build   nvcc builds the five kernels from src/repro_torch/kernels/csrc,
           one process a source, all at once, and ptxas reports registers,
           shared memory and spills.
2. kernels each kernel against its plain version on the card, fp32 with
           rtol=atol=1e-4 (the sums run in another order) and bf16 with
           2e-2 (one bf16 rounding of the output; K1 with `k1_limit` and
           K2 with `k2_limit`, which follow the outputs' scale): K1 at the
           decode cases, K2 at the cases of the CPU tests and at the
           smollm-360m, hubert, deepseek-moe-16b and danube prefill shapes
           and at non-divisible lengths, each with the route
           `flash_attention._route` took (bf16 with 16-byte strides: the
           TMA/wgmma kernel; D = 20: mma.sync), and a planted fault (the
           last K/V tile's keys cut, against the plain version on all
           keys) at the hubert and smollm prefill shapes that must fail
           `k2_limit`; K3 at
           the CPU tests' shapes, deepseek's decode (4 and 16 rows) and
           prefill shapes, gate/up and down, the TMA kernels' tile edges
           and ragged ones, contiguous and row-strided, through every
           route that can take each (`gmm_routes`: the one
           `moe_gmm._route` picks, then the others forced), and a planted
           fault (the last k-step taken out of the TMA kernels' output at
           deepseek's prefill, gate/up in the tall tile and down in the
           wide one, and at its 16-row decode) that the check must fail;
           K4 at the CPU tests'
           shapes, a ragged chunk, route tc's edges (H off its head groups,
           Q off its query tile, one chunk) and mamba2-2.7b's full width,
           through every route that can take each (`ssd_routes`: the one
           `ssd_scan._route` picks, then route fwd forced where it picked
           tc), against the exact recurrence and the model's chunked
           algebra, both in fp32, elementwise (see `ssd_close`), and a
           planted fault (the last chunk's local state dropped from route
           tc's final state at mamba2-2.7b's shape) that the check must
           fail; K5 at the CPU tests' shapes,
           ragged S and W, the ring's edges (S off its 32-step tile, W off
           its 64 channels, one tile) and recurrentgemma-9b's full width,
           the first entry through every route that can take each
           (`rglru_routes`: the ring where its copies can go, then route
           fwd, the one-thread-a-channel kernel, forced) against the exact
           recurrence, the
           gated entry (r, i, x in, a and b formed in the kernel) against
           `ref.rglru_gated_ref`, both by `rglru_close`, and a planted
           fault at full width on the ring (the carry into the last tile
           dropped; the first entry in fp32, the gated in bf16) that the
           check must fail;
           K2 and K1 also at recurrentgemma-9b's local attention (MQA,
           G=16, D=256, window 2048; B=1 S=4096 so that the window masks;
           K1 on a 2048-slot ring past its wrap). K1 in both layouts and at
           the edges of its split of the cache (ragged last split, a window
           ending inside a split, empty splits, a fully masked row at
           W=2048, G=7 D=128, G=4 D=120); fully masked rows exactly 0; a
           planted fault (the last split dropped) at W=32768 and at the
           W=2048 ring must fail K1's bf16 limit.
3. serve   two full smollm-360m InferenceServers and a Gateway on the port's
           UsfRuntime(Topology(2,1), SchedCoop) answer four clients; the
           kernel's launch count must equal attention layers x engine
           steps (LM.attention_layers); when each request reached each
           server and was admitted to a slot is logged.
3b. multiproc  two full smollm-360m server processes behind the port's
           MultiProcessGateway, node slots brokered by the NodeBroker
           (2 node slots for 2 x 2 runtime slots), supervised: the
           children start at once; nvidia-smi lists two more compute
           processes (in a container it may show one PID for all, so
           the lines are counted); the broker's quotas
           split the node, and under load both servers hold grants that
           sum to it; each child's greedy tokens for 4 prompts of 32
           tokens (32 new, one request at a time) equal those of an
           in-process InferenceServer on the same seed; each child's
           engine steps and K1 launches, carried back in its responses,
           give K1 = attention layers x steps; 4 concurrent clients
           through the gateway, coordinated and then free-running
           (coordinate=False), print tokens a second and the median and
           max gateway latency beside the card (not asserted); no child
           restarts, every child exits 0.
4. parity  16 teacher-forced decode steps at full width in bf16: every
           attention call of the kernel against the plain version on the
           same inputs (2e-2), and the logits with the kernel and with the
           plain attention (2e-2 of the largest logit) on weights whose
           attention scores are O(1) (see `conditioned`).
5. timing  the kernel, its plain version and a library call computing the
           same function, at the serve shape and at a long cache (CUDA
           events, L2 flushed before each launch; device time, and for K1's
           rows also without the device spin and the wrapper's host time);
           engine step time.
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
           yardstick, never called by the port) at the smollm-360m, hubert
           and deepseek-moe-16b prefill shapes and at a 32k-token row; the
           full-width forward's wall time and tokens/s; a profile of one
           forward, which must show all of K2's device time in the TMA
           kernel (`FLASH_TMA`; so too in phases 8 and 10).
8. moe     deepseek-moe-16b (28 layers, 64 experts top-6 + 2 shared),
           drawn in bf16: served as in 3 (K1 = 28 x steps, K3 = 3 x 27 x
           steps, all through the decode kernel); its forward at B=4,
           S=2048 (28 K2 and 81 K3 launches, all K3 through the prefill
           kernel), every K3 and K2 call against its plain version (K2 as
           in 6),
           and the logits against
           the plain expert product with the plain run's routing pinned to
           K3's (2e-2 of the largest logit: unpinned, bf16 near ties flip
           the top-6); K3, plain and torch.bmm times at the served decode
           (16 rows) and prefill shapes, gate/up and down; decode step and
           forward times with the kernels and with their plain versions,
           and profiles, which must show all of K3's device time in the
           route's kernel (`GMM_KERNELS`).
9. ssm     mamba2-2.7b (64 layers), fp32 weights and a bf16 copy: its
           forward at B=4, S=2048 (64 K4 launches, all on route tc); every
           K4 call against the exact recurrence; on weights with Mamba-2's published dt and
           A init (`mamba2.published_dt_A`: the specs' init is chaotic at
           this depth, ROADMAP Queue 3), the fp32 forward (K4) against
           teacher-forced decode at every position of a 768-token prompt
           (three chunks, so the state carried between chunks reaches the
           logits) within 2e-2 of the largest logit, and every K4 call of
           the bf16 forward against the recurrence; K4 times on route tc
           and on route fwd forced, beside the bound of each, forward times
           with K4 and the chunked scan, a profile, which must show all of
           K4's device time in route tc's kernels (`SSD_KERNELS`), and the
           decode step's time. Served as in 3 (no K1: 0 launches), each
           admitted request from a fresh state (LM.reset_slot).
10. hybrid recurrentgemma-9b (38 layers: 12 superblocks of rec, rec,
           local attention, and 2 tail rec blocks), drawn in bf16: its
           forward at B=4, S=2048 (12 K2 and 26 K5 launches, all K5
           through the gated entry on the ring); every K5 call against
           `ref.rglru_gated_ref` (`rglru_close`: y at bf16's TOL, h at
           fp32's) and every K2 call against the plain version (with the
           bf16-P term);
           the logits against the forward with both plain versions on
           `conditioned` weights (2e-2 of the largest logit); 128
           teacher-forced decode steps (K1, 12 launches a step, and the O(1)
           recurrence) with every K1 call against the plain version
           (`k1_limit`), and
           their logits against the same decode with the plain attention
           (2e-2 of the largest logit; prefill against decode in bf16 is
           `python -m repro_torch.launch.hybrid_conditioning`, ROADMAP
           Queue 3); K5's first entry on the ring and on route fwd, its
           plain version and the model's CPU algorithm (the doubling scan)
           run on the card, the gated entry against its plain version and
           the unfused model path (eager gate math, then route fwd), K2 against its plain version
           and scaled_dot_product_attention at D=256, K1 on the hybrid's
           rings; forward and decode step times, a profile, which must
           show all of K5's device time in the ring (`RGLRU_KERNELS`), peak
           memory.
           Served as in 3 on the `conditioned` weights (K1 = 12 x engine
           steps), then served again with every K1 call held against the
           plain version (`k1_limit`).
11. vlm    qwen2-vl-7b (28 layers, H=28 KV=4 D=128, M-RoPE sections
           (16, 24, 24), patch frontend 3584), fp32 weights and a bf16
           compute copy on `conditioned` weights; not served (the engine
           feeds token ids): its forward through make_prefill_step at B=4,
           S=2048 on make_batch's patch embeddings with Qwen2-VL's
           position layout (`vlm_positions`: text, an image of 32 x 56
           patches with t constant, h the row, w the column, text from the
           largest position + 1), 28 K2 launches, every K2 call against
           the plain version (as in 6), and the logits against the plain
           attention's (2e-2 of the largest logit); 64 teacher-forced
           decode steps through make_serve_step on [4,1,3584] embeddings
           and [3,4] positions (`decode_streams`: stream 0 arange, 1 s //
           32, 2 s % 32 + 7), 28 x 64 K1 launches, every K1 call against
           the plain version (`k1_limit`), and the decode logits against
           the prefill of the same embeddings and streams (2e-2 of the
           largest logit; the same gap with K1 and K2 both plain, and in
           fp32, printed beside it); K2 and K1 at the model's shapes
           against their plain versions and SDPA, forward and decode step
           times, profiles (all of K2's device time in `FLASH_TMA`), peak
           memory.
14. distribution (M11) full-width smollm-360m, phase 13's train step
           (8 x 2048 in 2 microbatches, remat full, AdamW). (a) The port's
           dry run (`launch/dryrun.py run_cell` on a one-card mesh, traced
           on fake tensors in a process started before phase 12, so the
           CPU trace overlaps phases 12-13) against the card: the real step under
           `plain_ops(**ops.PLAIN)` (the aten ops that were traced) must
           count the traced FLOPs to the FLOP (`FlopCounterMode`), take
           longer than the roofline's step time (H100 rates), and peak
           (`max_memory_allocated`) inside `MEM_BAND` of the traced peak.
           (b) Two ranks on the one card (spawned, gloo, store in a
           temporary directory; `dist_child`): the data-parallel step
           under a `(data=2)` mesh with `embed` unsharded, K2 on each
           rank's shards, against the single-process step on the whole
           batch (loss, params, m and v within `dp_bounds`, the fp32
           reorder of the gradient sum carried through AdamW); the int8
           `compressed_psum` over that step's gradients against the exact
           all-reduce (within n · scale / 2 + fp32 rounding); `gpipe_forward`
           of the 32 layers as two stages over the ranks, 4 microbatches,
           against the single-process forward; and a checkpoint saved by
           one process, restored by both with `shardings=`, whose
           data-parallel step must equal the single-process step from it.
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
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # CUDA cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def k1_limit(want):
    """K1's bf16 limit, elementwise, on |kernel - plain| for the plain
    version's output ``want`` (the fp32 of a bf16 tensor): one bf16 ulp of
    the output, 2^-7 |want| (both round nearly the same fp32 value, which
    may straddle a rounding boundary), plus 2^-8 of the call's largest
    |want|, at most 2e-2, for what differs in fp32 (the sum order; P enters
    P V as hi + lo bf16 terms, ~16 bits). It follows the outputs' scale: a
    fixed 2e-2 would be twice a typical output at W=32768 (~0.009), where
    phase 2's planted fault moves outputs by ~1e-3. Never looser than 2e-2
    + 2e-2 relative."""
    import torch

    return 2.0 ** -7 * want.abs() + torch.clamp(2.0 ** -8 * want.abs().amax(),
                                                max=2e-2)


def fixed_limit(tol):
    """tol + tol relative, elementwise, on |kernel - plain|."""
    return lambda want: tol + tol * want.abs()


K1_LIMIT_TEXT = "2^-7 |want| + min(2e-2, 2^-8 max|want|)"
DECODE_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
DECODE_REPLACES = "src/repro/kernels/decode_attention.py:67"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:88"
FLASH_TMA = "flash_fwd_tma_wgmma"  # K2's kernel on every main path (its name)
GMM_SOURCE = "src/repro_torch/kernels/csrc/moe_gmm.cu"
GMM_REPLACES = "src/repro/kernels/moe_gmm.py:44"
# K3's kernel by route (moe_gmm._route): the deepseek forward runs all of
# its K3 calls in GMM_KERNELS["tma"], the served decode in "tma_decode"
GMM_KERNELS = {"tma": "gmm_tma_wgmma", "tma_decode": "gmm_decode_tma_wgmma",
               "mma": "gmm_bf16", "f32": "gmm_f32"}
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan.py:75"
# K4's kernels by route (ssd_scan._route), as name prefixes: route tc is
# three kernels (ssd_tc_state, ssd_tc_pass, ssd_tc_out), and the mamba2
# forward runs all of its K4 calls there; "ssd_" names every K4 kernel
SSD_KERNELS = {"tc": "ssd_tc_", "fwd": "ssd_fwd"}
SSD_ANY = "ssd_"
RGLRU_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
RGLRU_REPLACES = "src/repro/kernels/rglru_scan.py:52"
# K5's kernels by route (rglru_scan._route): "ring" takes both entries, and
# the recurrentgemma forward runs all of its K5 calls there, through the
# gated entry; "fwd" is the one-thread-a-channel kernel; "rglru_" names
# every K5 kernel
RGLRU_KERNELS = {"ring": "rglru_ring", "fwd": "rglru_fwd"}
RGLRU_ANY = "rglru_"
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
    # the edges of the kernel's split of W (64-slot tiles; see
    # decode_attention._plan): W not a multiple of a split; a window ending
    # inside a split, most splits wholly out of it; splits wholly empty
    # beside valid ones; a fully masked row at W=2048; G=7 and G=4 at D=128
    # and D=120 (padded to 128 in shared memory)
    ("W200 ragged last split", 2, 8, 2, 200, 64, [199, 150], None, ()),
    ("W2048 window 100 inside a split", 2, 6, 2, 2048, 64, [1999, 3000], 100, ()),
    ("W2048 empty splits beside valid", 2, 6, 2, 2048, 32, [70, 2047], None, ()),
    ("W2048 fully masked row", 2, 6, 3, 2048, 64, [5, 1500], None, (0,)),
    ("G16 D256 W2048 B1", 1, 16, 1, 2048, 256, [3000], 2048, ()),
    ("G7 D128 W300", 2, 14, 2, 300, 128, [299, 100], None, ()),
    ("G4 D120 W300 window 200", 2, 8, 2, 300, 120, [299, 250], 200, ()),
]
# the bf16 cases at which phase 2 plants a fault that the limit must catch
PLANTED_FAULT_CASES = ("long cache W32768",
                       "recurrentgemma ring W2048 G16 D256 w2048")


def phase_kernels(dev) -> float:
    """K1 against its plain version; returns the largest abs error."""
    import torch

    from repro_torch.kernels import decode_attention, ops

    def kernel_layout(q, k, v, c, p, *, window):
        """The kernel's own layout [B,KV,W,D], contiguous."""
        return decode_attention.flash_decode(
            q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            c, p, window=window)

    gen = torch.Generator(device=dev).manual_seed(1234)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        limit = (fixed_limit(TOL["float32"]) if dtype == torch.float32
                 else k1_limit)
        limit_text = (f"{TOL['float32']:g} + {TOL['float32']:g} relative"
                      if dtype == torch.float32 else K1_LIMIT_TEXT)
        for name, B, H, KV, W, D, qpos, window, masked in DECODE_CASES:
            q, k, v, cpos, qp = decode_inputs(gen, dev, dtype, B, H, KV, W, D,
                                              qpos, masked_rows=masked)
            expect = plain_decode(q, k, v, cpos, qp, window=window).float()
            slots = decode_attention._slots(
                dev.index, decode_attention._DTYPE_CODE[dtype], D)
            nsplit, split_len = decode_attention._plan(B, KV, H // KV, W, slots)
            for lay, fn in (("model layout", ops.flash_decode),
                            ("kernel layout", kernel_layout)):
                out = fn(q, k, v, cpos, qp, window=window)
                torch.cuda.synchronize()
                got = out.float()
                err = (got - expect).abs().max().item()
                worst = max(worst, err)
                ok = bool(((got - expect).abs() <= limit(expect)).all())
                for b in masked:
                    ok = ok and bool((got[b] == 0).all())
                log(f"[kernels] flash_decode {name:32s} {lay:12s} "
                    f"splits {nsplit:3d} x {split_len:5d} of {slots} CTA slots "
                    f"{str(dtype):14s} max_abs_err={err:.3e} (|want| up to "
                    f"{expect.abs().max().item():.3e}; limit {limit_text}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_decode disagrees with its "
                                         f"plain version: {name}, {lay}, {dtype}")
            if dtype == torch.bfloat16 and name in PLANTED_FAULT_CASES:
                # a planted fault the limit must resolve: the kernel on the
                # same inputs with the last split's slots masked, which is
                # what a kernel that dropped its last split would write
                lo = (nsplit - 1) * split_len
                dropped = cpos.clone()
                dropped[:, lo:] = -1
                got = ops.flash_decode(q, k, v, dropped, qp, window=window).float()
                over = (got - expect).abs() > k1_limit(expect)
                log(f"[kernels] flash_decode {name:32s} planted fault, the last "
                    f"of {nsplit} splits (slots {lo}..{W - 1}) dropped: max_abs_err="
                    f"{(got - expect).abs().max().item():.3e}, {int(over.sum())} "
                    f"elements over the limit: "
                    f"{'FAIL, as it must' if over.any() else 'passes: NOT RESOLVED'}")
                if not over.any():
                    raise AssertionError(f"K1's bf16 limit does not resolve a "
                                         f"dropped split at {name}")
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
    # the TMA kernel at hubert's D=80 and deepseek's D=128, narrow and
    # ragged, and at smollm's G=3 long enough to wrap its K/V ring
    ("hubert narrow S300 D80 bidir", 2, 300, 300, 4, 4, 80, False, None),
    ("deepseek narrow S333 D128 causal", 2, 333, 333, 4, 4, 128, True, None),
    ("smollm G3 D64 S700 causal, wraps the ring", 2, 700, 700, 6, 2, 64, True, None),
    ("deepseek prefill B4 S2048 D128", 4, 2048, 2048, 16, 16, 128, True, None),
]
# the bf16 cases at which phase 2 plants a fault that the check must catch
FLASH_PLANTED_FAULT_CASES = ("hubert B4 S1024 bidir", "smollm prefill B4 S2048")


def k2_limit(want, spread):
    """K2's bf16 limit, elementwise, on |kernel - plain| for the plain
    version's output ``want`` and ``spread`` = sum_j p_j |v_j| (the plain
    version on |v|), both the fp32 of bf16 tensors: one bf16 ulp of the
    output, 2^-7 |want| (both round nearly the same fp32 value, which may
    straddle a rounding boundary), plus 2^-8 sum_j p_j |v_j| for the
    kernel's rounding of each probability to bf16 for the P V product
    (a relative error of at most 2^-9 on each p_j) and what differs in fp32
    (the sum order, exp2 with the scale folded in). It follows each
    output's scale: at the smollm and hubert prefill shapes most outputs
    are 0.03-0.06 and a fixed 2e-2 hides a dropped K/V tile in all but a
    few thousand of millions of elements. Never looser than 2e-2 + 2e-2
    relative."""
    import torch

    return torch.minimum(2.0 ** -7 * want.abs() + 2.0 ** -8 * spread,
                         TOL["bfloat16"] * (1 + want.abs()))


K2_LIMIT_TEXT = "min(2^-7 |want| + 2^-8 sum_j p_j |v_j|, 2e-2 + 2e-2 |want|)"


def phase_flash_kernels(dev):
    """K2 against its plain version; returns the largest abs error and, for
    each planted-fault case, how many elements of the faulty output exceed
    the bf16 limit (fatal unless some do)."""
    import torch

    from repro_torch.kernels import build, flash_attention, ops

    gen = torch.Generator(device=dev).manual_seed(4321)
    worst, planted = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).removeprefix("torch.")]
        for name, B, Sq, Sk, H, KV, D, causal, window in FLASH_CASES:
            q, k, v = flash_inputs(gen, dev, dtype, B, Sq, Sk, H, KV, D)
            route = flash_attention._route(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2))
            layouts = {"model layout": lambda q, k, v: ops.flash_attention(
                q, k, v, causal=causal, window=window)}
            if Sq <= 512:  # the kernel's own layout, contiguous
                layouts["kernel layout"] = lambda q, k, v: flash_attention.\
                    flash_attention_fwd(
                        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal,
                        window=window).transpose(1, 2)
            expect = plain_flash(q, k, v, causal=causal, window=window).float()
            if dtype == torch.float32:
                limit, limit_text = fixed_limit(tol)(expect), f"{tol:g} + {tol:g} relative"
            else:
                spread = plain_flash(q, k, v.abs(), causal=causal,
                                     window=window).float()
                limit, limit_text = k2_limit(expect, spread), K2_LIMIT_TEXT
                del spread
            for lay, fn in layouts.items():
                got = fn(q, k, v)
                torch.cuda.synchronize()
                got = got.float()
                d = (got - expect).abs()
                err = d.max().item()
                worst = max(worst, err)
                ok = got.shape == expect.shape and bool((d <= limit).all())
                log(f"[kernels] flash_attention {name:34s} {lay:12s} "
                    f"{str(dtype):14s} route {route:3s} max_abs_err={err:.3e}, "
                    f"largest |err|/limit {(d / limit.clamp_min(1e-30)).max().item():.3f} "
                    f"(limit {limit_text}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"flash_attention disagrees with its "
                                         f"plain version: {name}, {lay}, {dtype}")
            if dtype == torch.bfloat16 and name in FLASH_PLANTED_FAULT_CASES:
                # a planted fault the limit must resolve: the kernel on the
                # keys with the last tile cut, which is what a kernel that
                # dropped its last K/V tile would write, against the plain
                # version on all keys
                bk = build.cu_constant("flash_attention",
                                       "TMA_BK" if D <= 128 else "TMA_BK_D256")
                got = ops.flash_attention(q, k[:, :Sk - bk], v[:, :Sk - bk],
                                          causal=causal, window=window).float()
                d = (got - expect).abs()
                over = int((d > limit).sum())
                flat = int((d > fixed_limit(tol)(expect)).sum())
                log(f"[kernels] flash_attention {name:34s} planted fault, the last "
                    f"{bk} keys ({Sk - bk}..{Sk - 1}) dropped: max_abs_err="
                    f"{d.max().item():.3e}, largest |err|/limit "
                    f"{(d / limit.clamp_min(1e-30)).max().item():.3f}, {over} of "
                    f"{d.numel()} elements over the limit ({flat} over a flat "
                    f"{tol:g} + {tol:g} relative): "
                    f"{'FAIL, as it must' if over else 'passes: NOT RESOLVED'}")
                planted[name] = over
                if not over:
                    raise AssertionError(f"K2's bf16 limit does not resolve a "
                                         f"dropped K/V tile at {name}")
            del q, k, v, expect, limit
    return worst, planted


def phase_serve(dev, cfg, *, params=None, prompt_len=32, max_new=32, clients=4,
                checked=False):
    """Two servers + a gateway answer `clients` requests; returns stats.

    ``params`` (one tree both servers share) replaces each server's own
    seeded initialisation. With ``checked`` every K1 call of the run is
    also held against the plain version on the same inputs (``k1_limit``),
    and the times include the checks. Logs when each request reached each
    server (the client's task ran) and when the server admitted it to a
    slot."""
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
        requests = {s.name: [] for s in servers}
        for s in servers:
            def submit(req, submit=s.submit, kept=requests[s.name]):
                kept.append(req)
                return submit(req)
            s.submit = submit

        def client(i):
            return lambda: results.__setitem__(
                i, gw.handle(prompts[i], max_new=max_new, timeout=600.0))

        checks = (checked_attention(k1_limit) if checked
                  else contextlib.nullcontext([]))
        with checks as found:
            decode_attention.flash_decode.launches = 0
            moe_gmm.moe_gmm.launches = 0
            moe_gmm.moe_gmm.route_launches = dict.fromkeys(
                moe_gmm.moe_gmm.route_launches, 0)
            m0 = time.monotonic()
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
            gmm_routes = {r: n for r, n in moe_gmm.moe_gmm.route_launches.items()
                          if n}
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
    n_attn = servers[0].model.attention_layers()
    want = n_attn * sum(steps)
    moe_layers = cfg.n_layers - cfg.first_k_dense if cfg.family == "moe" else 0
    want_gmm = 3 * moe_layers * sum(steps)
    log(f"[serve] {cfg.name}: {clients} clients x {len(servers)} servers served "
        f"{served}; engine steps {steps}; flash_decode launches {launches} (want "
        f"{n_attn} attention layers x {sum(steps)} = {want}); moe_gmm launches "
        f"{gmm_launches} (want 3 x {moe_layers} MoE layers x {sum(steps)} = "
        f"{want_gmm}; by route {gmm_routes})")
    if launches != want or gmm_launches != want_gmm:
        raise AssertionError(f"flash_decode launched {launches} times (want "
                             f"{want}), moe_gmm {gmm_launches} (want {want_gmm}): "
                             f"the decode path bypassed a kernel")
    if checked:
        err = max((e.item() for e, _ in found), default=0.0)
        ok = len(found) == launches and all(x.item() <= 0 for _, x in found)
        log(f"[serve] {cfg.name}: every K1 call of the served run against the "
            f"plain version on the same inputs: {len(found)} calls, max_abs_err="
            f"{err:.3e} (limit {K1_LIMIT_TEXT}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a served K1 call disagrees with the plain version")
    same = sum(r["outputs"]["srv-a"] == r["outputs"]["srv-b"]
               for r in results.values())
    tokens = sum(len(o) for r in results.values() for o in r["outputs"].values())
    lat = sorted(r["latency"] for r in results.values())
    for name, reqs in requests.items():
        log(f"[serve] {cfg.name} {name}: requests (s after the start: reached the "
            f"server, admitted to a slot, done): " + ", ".join(
                f"({r.arrival - m0:.3f}, {r.started - m0:.3f}, {r.finished - m0:.3f})"
                for r in reqs))
    log(f"[serve] {cfg.name}{' (checked)' if checked else ''}: wall "
        f"{wall:.3f} s; {tokens} generated tokens "
        f"({tokens / wall:.1f} tok/s, prefill {prompt_len} x "
        f"{clients * len(servers)} more); request latency s {lat}; "
        f"identical outputs on both servers (same seed) for {same}/{clients}")
    return {"launches": launches, "gmm_launches": gmm_launches,
            "gmm_routes": gmm_routes, "steps": sum(steps), "wall_s": wall,
            "tok_per_s": tokens / wall,
            "params": servers[0].params}


#: the multi-process serve: two runtimes of 2 slots each want 4 slots of a
#: node that has 2, oversubscribed 2x as in the paper
MULTIPROC = {"archs": {"srv-a": "smollm_360m", "srv-b": "smollm_360m"},
             "node_capacity": 2, "slots_per_server": 2, "max_batch": 4,
             "max_len": 512, "smoke": False}


def compute_apps() -> list[str]:
    """The card's compute processes, one line each as nvidia-smi lists them
    (in a container it may show every process under one PID, so a caller
    counts the lines)."""
    r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return [line for line in r.stdout.splitlines() if line.strip()]


def serve_alone(dev, cfg, prompts, max_new, *, max_batch, max_len):
    """Greedy tokens of one in-process server (seed 0), the prompts served
    one at a time."""
    from repro_torch.core.policies import SchedCoop
    from repro_torch.core.threads import UsfRuntime
    from repro_torch.core.topology import Topology
    from repro_torch.serve.engine import InferenceServer, Request

    usf = UsfRuntime(Topology(2, 1), SchedCoop())
    try:
        server = InferenceServer("in-process", cfg, usf, max_batch=max_batch,
                                 max_len=max_len, seed=0, device=dev)
        server.start()
        out = []
        for p in prompts:
            req = server.submit(Request(tokens=list(p), max_new=max_new))
            if not req.done.wait(timeout=600.0):
                raise AssertionError("the in-process server did not answer")
            out.append(list(req.output))
        server.stop()
    finally:
        usf.shutdown(timeout=10.0)
    return out


def concurrent_clients(gw, prompts, max_new):
    """One client thread a prompt, all calling ``gw.handle`` at once;
    returns the wall seconds and the gateway's records."""
    import threading

    recs, errors = [None] * len(prompts), []

    def client(i):
        try:
            recs[i] = gw.handle(prompts[i], max_new=max_new, timeout=600.0)
        except Exception as e:  # noqa: BLE001 - reported below, fails the run
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), name=f"client{i}")
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900.0)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"gateway clients failed: {errors!r}")
    return wall, recs


def child_counts(recs) -> dict:
    """Each child's engine steps and K1 launches at its latest response
    (both count up from the child's start)."""
    out = {}
    for rec in recs:
        for name, steps in rec["steps"].items():
            k1 = rec["launches"][name]["flash_decode"]
            old = out.get(name, (0, 0))
            out[name] = (max(old[0], steps), max(old[1], k1))
    return out


def check_child_k1(before, after, n_attn, want_steps, what) -> int:
    """Each child decoded ``want_steps`` engine steps between the two
    readings, every one through K1 (``n_attn`` launches a step)."""
    total = 0
    for name in after:
        steps = after[name][0] - before[name][0]
        k1 = after[name][1] - before[name][1]
        log(f"[multiproc] {what} {name}: {steps} engine steps, flash_decode "
            f"launches {k1} (want {n_attn} attention layers x {want_steps} = "
            f"{n_attn * want_steps})")
        if steps != want_steps or k1 != n_attn * want_steps:
            raise AssertionError(f"{name}: {steps} steps and {k1} K1 launches, "
                                 f"want {want_steps} and {n_attn * want_steps}: "
                                 f"the child's decode bypassed the kernel")
        total += k1
    return total


@contextlib.contextmanager
def grant_samples(broker, every=0.05):
    """The broker's grants by worker, sampled every ``every`` seconds while
    the block runs."""
    import threading

    samples, stop = [], threading.Event()

    def sample():
        while not stop.wait(every):
            workers = broker.snapshot()["workers"]
            samples.append({n: w["granted"] for n, w in workers.items()})

    t = threading.Thread(target=sample, name="grant-sampler", daemon=True)
    t.start()
    try:
        yield samples
    finally:
        stop.set()
        t.join(10.0)


def check_grants(samples, names, capacity) -> None:
    """Under load both servers held a grant at once, and the grants summed
    to the node's capacity and never above it."""
    full = [s for s in samples if sorted(s) == names
            and all(s.values()) and sum(s.values()) == capacity]
    over = [s for s in samples if sum(s.values()) > capacity]
    log(f"[multiproc] broker under load: {len(samples)} samples of the grants, "
        f"{len(full)} with both servers granted summing to {capacity}, "
        f"{len(over)} above it; first {samples[:1]}, last {samples[-1:]}")
    if not full or over:
        raise AssertionError(f"broker grants under load never split the node "
                             f"between both servers, or exceeded it: {samples}")


def colocation(recs, wall, tag, card_text) -> dict:
    tokens = sum(len(o) for r in recs for o in r["outputs"].values())
    lat = sorted(r["latency"] for r in recs)
    row = {"tok_per_s": tokens / wall, "wall_s": wall, "tokens": tokens,
           "latency_median_s": statistics.median(lat), "latency_max_s": lat[-1]}
    log(f"[multiproc] {tag}: {len(recs)} clients x 2 server processes, "
        f"{tokens} generated tokens in {wall:.3f} s: {row['tok_per_s']:.1f} "
        f"tok/s; gateway latency median {row['latency_median_s']:.3f} s, max "
        f"{row['latency_max_s']:.3f} s (all {[round(x, 3) for x in lat]}); "
        f"card {card_text}")
    return row


def phase_multiproc(dev, cfg, *, prompt_len=32, max_new=32, clients=4,
                    warm_len=4):
    """Two server processes behind the port's MultiProcessGateway, node
    slots brokered by the NodeBroker: (a) both children on the card, the
    broker's quotas splitting the node's 2 slots and, under load, both
    holding grants that sum to them; (b) each
    child's tokens equal to an in-process server's on the same seed, the
    prompts served one at a time, every engine step of each child through
    K1; (c) 4 concurrent clients, coordinated and free-running; (d) every
    child stops cleanly. Returns the K1 launches of (b) and (c)'s rows."""
    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.serve.multiproc import MultiProcessGateway

    t_phase = time.perf_counter()
    opts = dict(MULTIPROC)
    archs = opts.pop("archs")
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab, (prompt_len,), generator=g).tolist()
               for _ in range(clients)]
    n_attn = build_model(cfg).attention_layers()
    want = serve_alone(dev, cfg, prompts, max_new, max_batch=opts["max_batch"],
                       max_len=opts["max_len"])
    card_text = card()
    rows, launches = {}, 0
    for coordinate in (True, False):
        tag = "coordinated" if coordinate else "free-running"
        gw = MultiProcessGateway(archs, coordinate=coordinate, **opts)
        sampler = contextlib.ExitStack()
        try:
            apps0 = compute_apps()
            t0 = time.perf_counter()
            gw.start(ready_timeout=300.0)
            started = time.perf_counter() - t0
            pids = {s.name: s.pid for s in gw.servers}
            apps = compute_apps()
            log(f"[multiproc] {tag}: {len(pids)} server processes {pids} ready "
                f"in {started:.3f} s (built at once); nvidia-smi compute apps "
                f"before {apps0}, after {apps}")
            if len(apps) - len(apps0) != len(pids):
                raise AssertionError(f"server processes {pids} are not all "
                                     f"compute processes on the card: {apps0} "
                                     f"before, {apps} after")
            if coordinate:
                snap = gw.broker.snapshot()["workers"]
                quotas = {n: w["quota"] for n, w in snap.items()}
                log(f"[multiproc] broker at start: capacity "
                    f"{opts['node_capacity']}, quotas {quotas}, grants "
                    f"{ {n: w['granted'] for n, w in snap.items()} } (an idle "
                    f"server's demand decays to 0)")
                if (sorted(quotas) != sorted(archs)
                        or sum(quotas.values()) != opts["node_capacity"]):
                    raise AssertionError(f"broker quotas {quotas}, want both "
                                         f"servers summing to "
                                         f"{opts['node_capacity']}")
                grants = sampler.enter_context(grant_samples(gw.broker))
            # warm each child (CUDA context, cuBLAS handle, module loads)
            warm = gw.handle(prompts[0][:warm_len], max_new=warm_len,
                             timeout=600.0)
            before = child_counts([warm])
            if coordinate:
                got = {name: [] for name in archs}
                t0 = time.perf_counter()
                for p in prompts:
                    rec = gw.handle(p, max_new=max_new, timeout=600.0)
                    for name, out in rec["outputs"].items():
                        got[name].append(out)
                one_at_a_time = time.perf_counter() - t0
                for name, outs in got.items():
                    same = sum(a == b for a, b in zip(outs, want))
                    log(f"[multiproc] {name}: tokens of {len(outs)} requests x "
                        f"{max_new} equal the in-process server's (seed 0, "
                        f"one at a time) for {same}/{len(want)}")
                    for i, (a, b) in enumerate(zip(outs, want)):
                        if a != b:
                            k = next(j for j, (x, y) in enumerate(zip(a, b))
                                     if x != y)
                            raise AssertionError(
                                f"{name} request {i}: token {k} is {a[k]}, the "
                                f"in-process server's is {b[k]}")
                after = child_counts(gw.responses)
                launches = check_child_k1(
                    before, after, n_attn, clients * (prompt_len - 1 + max_new),
                    "one at a time")
                log(f"[multiproc] one at a time: {clients} requests in "
                    f"{one_at_a_time:.3f} s")
                before = after
            wall, recs = concurrent_clients(gw, prompts, max_new)
            check_child_k1(before, child_counts(recs), n_attn,
                           clients * (prompt_len - 1 + max_new),
                           f"{tag} clients")
            rows[tag] = colocation(recs, wall, tag, card_text)
            if coordinate:
                sampler.close()
                check_grants(grants, sorted(archs), opts["node_capacity"])
                b = gw.broker.snapshot()
                log(f"[multiproc] broker counters: {b['regrants']} regrants "
                    f"({b['demand_regrants']} on demand), {b['grants_pushed']} "
                    f"grants pushed, {b['reclaims']} leases reclaimed")
            snap = gw.snapshot()["servers"]
            retried = [r["retried"] for r in gw.responses if r["retried"]]
            if retried or any(s["restarts"] or s["failed"] or not s["alive"]
                              for s in snap.values()):
                raise AssertionError(f"a server process died: {snap}, "
                                     f"retried {retried}")
        finally:
            sampler.close()
            gw.stop()
        codes = {s.name: s._proc.exitcode for s in gw.servers}
        log(f"[multiproc] {tag}: stopped; child exit codes {codes}")
        if any(c != 0 for c in codes.values()):
            raise AssertionError(f"a server process exited with {codes}")
    ratio = {key: rows["coordinated"][key] / rows["free-running"][key]
             for key in ("tok_per_s", "latency_median_s", "latency_max_s")}
    log(f"[multiproc] coordinated / free-running: tok/s {ratio['tok_per_s']:.3f}, "
        f"median latency {ratio['latency_median_s']:.3f}, max latency "
        f"{ratio['latency_max_s']:.3f}; card {card_text}")
    log(f"[multiproc] phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "rows": rows, "ratio": ratio}


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
def checked_attention(limit):
    """Run the kernel and, on the same inputs, the plain version at every
    decode-attention call; yields the list of (max abs err, worst excess
    over ``limit(want)``, elementwise) per call."""
    from repro_torch.kernels import ops

    kernel, found = ops.flash_decode, []

    def checked(q, k, v, cpos, qpos, *, window=None):
        out = kernel(q, k, v, cpos, qpos, window=window)
        want = plain_decode(q, k, v, cpos, qpos, window=window).float()
        d = (out.float() - want).abs()
        found.append((d.max(), (d - limit(want)).max()))
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
        with checked_attention(fixed_limit(TOL["bfloat16"])) as found:
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


def time_ms(fn, flush, iters=50, warmup=5, *, spin=True) -> float:
    """Median device time of one call, the L2 flushed before each. A spin
    of ~0.5 ms on the device (``torch.cuda._sleep``) precedes each timed
    call, so that the host has queued the call before the device reaches
    it: the events then time the device alone, and not the host's work in
    a wrapper whose kernel is shorter than that work. With ``spin=False``
    (the earlier timer) the events time the device or the host's
    enqueue of the call, whichever is longer."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if spin:
            torch.cuda._sleep(1_000_000)
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


def host_us(fn, calls=200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work: the
    calls are issued behind a ~25 ms device spin, so none waits on the
    device."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_decode_shape(dev, flush, B, H, KV, W, D):
    """Kernel, plain and library times at one shape, every slot valid:
    device times (``time_ms``), the same without the spin (``*_nospin``),
    and the host's enqueue time of the kernel's wrapper."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, cpos, qp = decode_inputs(gen, dev, torch.bfloat16, B, H, KV, W, D,
                                      [W - 1] * B)
    q4 = q[:, :, None, :]
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)
    mask = ((cpos >= 0) & (cpos <= qp[:, None]))[:, None, None, :]
    fns = {"ms": lambda: ops.flash_decode(q, k, v, cpos, qp),
           "plain_ms": lambda: plain_decode(q, k, v, cpos, qp),
           "library_ms": lambda: F.scaled_dot_product_attention(
               q4, kT, vT, attn_mask=mask, enable_gqa=True)}
    row = {key: time_ms(fn, flush) for key, fn in fns.items()}
    row.update({f"{key}_nospin": time_ms(fn, flush, spin=False)
                for key, fn in fns.items()})
    row["host_us"] = host_us(fns["ms"])
    row["bound_ms"], row["bound_by"] = decode_bound(B, H, KV, W, D, "bfloat16")
    row["shape"] = f"B={B} H={H} KV={KV} W={W} D={D} bf16, model layout"
    return row


def decode_row_text(row) -> str:
    return (f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
            f"library_ms={row['library_ms']:.6f} (scaled_dot_product_attention, "
            f"yardstick) bound_ms={row['bound_ms']:.6f} ({row['bound_by']}, "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); without the device spin (host "
            f"enqueue shows): kernel {row['ms_nospin']:.6f} plain "
            f"{row['plain_ms_nospin']:.6f} library {row['library_ms_nospin']:.6f}; "
            f"the wrapper's host time {row['host_us']:.1f} us a call")


def step_inputs(dev, cfg, B, n, seed):
    """``n`` decode steps' inputs for B rows: (tokens [n,B], or embeddings
    [n,B,1,Din] for a non-token frontend; positions [n,B], or [n,3,B]
    under M-RoPE, step t at position t)."""
    import torch

    from repro_torch.models.base import torch_dtype

    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.frontend == "token":
        toks = torch.randint(0, cfg.vocab, (n, B), device=dev, dtype=torch.int32,
                             generator=gen)
    else:
        toks = torch.randn((n, B, 1, cfg.frontend_dim or cfg.d_model), device=dev,
                           generator=gen).to(torch_dtype(cfg.compute_dtype))
    pos = torch.arange(n, dtype=torch.int32, device=dev)[:, None].repeat(1, B)
    if cfg.mrope_sections is not None:
        pos = pos[:, None, :].repeat(1, 3, 1)
    return toks, pos


def time_engine_step(dev, cfg, params, *, B=4, steps=30, plain=None):
    """Host-clock ms of one full-width decode step (synchronised), with
    the kernels and with their plain versions (``plain``, a context
    manager; default the plain attention)."""
    import torch

    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder

    model, sharder = build_model(cfg), Sharder(None)
    toks, positions = step_inputs(dev, cfg, B, steps + 5, 9)

    def run():
        cache = fresh_cache(cfg, B, 512, dev)
        times = []
        with torch.inference_mode():
            for t in range(steps + 5):
                pos = positions[t]
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, cache, toks[t], pos, sharder)
                logits.argmax(-1).cpu()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[5:])

    kernel_ms = run()
    with (plain or plain_attention)():
        plain_ms = run()
    return kernel_ms, plain_ms


def profile_steps(dev, cfg, params, *, B=4, steps=3, keys=("flash_decode_",)):
    """torch.profiler over `steps` full-width decode steps (after one
    warm-up step): device-busy ms, kernel launches and the device ms of the
    kernels named by each of ``keys``, each per step. K1's key covers its
    split kernel (flash_decode_bf16, flash_decode_f32) and its combine
    (flash_decode_combine)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder

    model, sharder = build_model(cfg), Sharder(None)
    cache = fresh_cache(cfg, B, 512, dev)
    toks, positions = step_inputs(dev, cfg, B, steps + 1, 0)

    def step(t):
        logits, _ = model.decode_step(params, cache, toks[t], positions[t], sharder)
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


def all_in_kernel(what, kernel, total_ms, named_ms, name) -> float:
    """The share of a kernel's device time in a path (``total_ms``, the
    kernels of all its routes) that ran in the kernel called ``name``
    (``named_ms``); fails unless it is all of it."""
    share = named_ms / total_ms if total_ms > 0 else 0.0
    ok = total_ms > 0 and abs(total_ms - named_ms) <= 1e-9 * total_ms
    log(f"[profile] {what}: {kernel} {total_ms:.3f} ms of device time, "
        f"{named_ms:.3f} ms of it in {name} ({share * 100:.1f}%) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: {kernel} ran outside {name}")
    return share


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


def plain_moe():
    """Every kernel of the MoE path (K1, K2, K3) as its plain version."""
    return plain_ops(flash_decode=plain_decode, flash_attention=plain_flash,
                     moe_gmm=plain_gmm)


def plain_ssm():
    """The model's chunked algebra in place of K4 (``ops.PLAIN``): the plain
    yardstick of K4 in a forward (the kernel's own plain version, the O(S)
    recurrence ref.ssd_ref, is checked at every call)."""
    from repro_torch.kernels import ops

    return plain_ops(ssd_scan=ops.plain_ssd_scan)


GMM_CASES = [
    # name, E, C, D, F
    ("test_kernels 2x64x32x48", 2, 64, 32, 48),
    ("test_kernels 4x100x64x96", 4, 100, 64, 96),
    ("test_kernels 1x128x128x128", 1, 128, 128, 128),
    ("deepseek smoke wg, B2 x C6", 8, 12, 64, 32),
    ("deepseek smoke wd, B2 x C6", 8, 12, 32, 64),
    ("deepseek decode wg C4", 64, 4, 2048, 1408),
    ("deepseek decode wd C4", 64, 4, 1408, 2048),
    # served decode: 4 slots of capacity 4
    ("deepseek decode wg C16", 64, 16, 2048, 1408),
    ("deepseek decode wd C16", 64, 16, 1408, 2048),
    ("deepseek prefill wg B4 x C241", 64, 964, 2048, 1408),
    ("deepseek prefill wd B4 x C241", 64, 964, 1408, 2048),
    ("ragged 3x5x37x19 (element loads)", 3, 5, 37, 19),
    ("ragged 3x40x40x24 (C tile edge)", 3, 40, 40, 24),
    # the TMA kernels' edges: C past a 256-row tile, D past a k-step, F
    # past a 128-column tile; the wide prefill tile's, C past 128 and F
    # past 256; at 16 rows D past a 128-deep k-step, F past 64
    ("prefill edges 3x300x72x136", 3, 300, 72, 136),
    ("wide edges 3x130x72x504", 3, 130, 72, 504),
    ("decode edges 2x16x200x72", 2, 16, 200, 72),
]
# the bf16 cases and routes at which phase 2 plants a fault that the check
# must catch: the last k-step's contribution taken out of the kernel's output
# (prefill: gate/up in the tall tile, down in the wide one)
GMM_PLANTED_FAULT_CASES = {"deepseek prefill wg B4 x C241": "tma",
                           "deepseek prefill wd B4 x C241": "tma",
                           "deepseek decode wg C16": "tma_decode"}


def gmm_routes(x, w) -> list[str]:
    """Every K3 route that can take x and w: the one ``moe_gmm._route``
    picks first, then the other bf16 routes (mma.sync takes any bf16 call;
    TMA needs 16-byte strides and bases, the decode kernel also at most
    DECODE_ROWS rows)."""
    from repro_torch.kernels import moe_gmm

    main = moe_gmm._route(x, w)
    if main in ("f32", "mma"):
        return [main]
    return [main] + [r for r in ("tma", "mma") if r != main]


def phase_gmm_kernels(dev) -> float:
    """K3, every route that can take each case, against its plain version;
    returns the largest abs error. A planted fault (one k-step's
    contribution taken out of a kernel's output) must fail the check."""
    import torch

    from repro_torch.kernels import build, moe_gmm

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
                want = plain_gmm(x, w).float()
                for i, route in enumerate(gmm_routes(x, w)):
                    got = (moe_gmm.moe_gmm(x, w) if i == 0
                           else moe_gmm.launch(x, w, route))
                    torch.cuda.synchronize()
                    err = (got.float() - want).abs().max().item()
                    worst = max(worst, err)
                    ok = got.shape == want.shape and torch.allclose(
                        got.float(), want, rtol=tol, atol=tol)
                    log(f"[kernels] moe_gmm {name:34s} {lay:16s} {str(dtype):14s} "
                        f"route {route:10s}{' (its own)' if i == 0 else ' (forced)':10s}"
                        f" max_abs_err={err:.3e} tol={tol:g} (+{tol:g} relative) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"moe_gmm disagrees with its plain "
                                             f"version: {name}, {lay}, {dtype}, "
                                             f"route {route}")
                    route_planted = GMM_PLANTED_FAULT_CASES.get(name)
                    if (dtype == torch.bfloat16 and lay == "[E,C,D]"
                            and route == route_planted):
                        # a planted fault the check must catch: the kernel's
                        # output less its last k-step's contribution, which
                        # is what a kernel that dropped that k-step would
                        # write
                        bk = build.cu_constant(
                            "moe_gmm", "TMA_BK" if route == "tma" else "DEC_BK")
                        k0 = (D - 1) // bk * bk
                        part = torch.bmm(x[:, :, k0:].float(), w[:, k0:].float())
                        bad = (got.float() - part).to(dtype).float()
                        caught = not torch.allclose(bad, want, rtol=tol, atol=tol)
                        over = int(((bad - want).abs() > tol + tol * want.abs()).sum())
                        log(f"[kernels] moe_gmm {name:34s} planted fault, route "
                            f"{route}: the last k-step (d {k0}..{D - 1}) taken out: "
                            f"max_abs_err={(bad - want).abs().max().item():.3e}, "
                            f"{over} of {want.numel()} elements over the check: "
                            f"{'FAIL, as it must' if caught else 'passes: NOT CAUGHT'}")
                        if not caught:
                            raise AssertionError(f"K3's check does not catch a "
                                                 f"dropped k-step at {name}")
                        del part, bad
                    del got
            del w, buf, layouts, want
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
    # route tc's edges: H off its head groups (16 an output CTA, 10 a state
    # CTA), one chunk (no state carried); Q100 above is off its 64-row tile
    ("H21 off the head groups B2 S512 H21 P64 N128 Q256", 2, 512, 21, 64, 128, 256),
    ("nc=1 B2 S256 H8 P64 N128 Q256", 2, 256, 8, 64, 128, 256),
    ("mamba2-2.7b B4 S2048 H80 P64 N128 Q256", 4, 2048, 80, 64, 128, 256),
]
# the bf16 case at which phase 2 plants a fault on route tc that the check
# must catch: the last chunk's local state dropped from the final state
SSD_PLANTED_FAULT_CASE = "mamba2-2.7b B4 S2048 H80 P64 N128 Q256"


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


def ssd_routes(x, Bm, Cm, chunk) -> list[str]:
    """Every K4 route that can take a call: the one ``ssd_scan._route``
    picks first, then "fwd" forced where it picked "tc" ("fwd" takes any
    call, "tc" only bf16 at its alignment and limits)."""
    from repro_torch.kernels import ssd_scan

    main = ssd_scan._route(x, Bm, Cm, chunk)
    return [main] + (["fwd"] if main == "tc" else [])


def last_chunk_state(x, dt, A, Bm, Q):
    """The last chunk's local state, sum_j exp(clip(cum_Q - cum_j)) dt_j x_j
    B_j^T [B,H,P,N], in fp32: what a state pass that dropped it would leave
    out of the final state."""
    import torch

    xq, dq, bq = x[:, -Q:].float(), dt[:, -Q:], Bm[:, -Q:].float()
    cum = torch.cumsum(dq * A, dim=1)
    w = torch.exp(torch.clamp(cum[:, -1:] - cum, -60.0, 0.0)) * dq
    return torch.einsum("bjh,bjn,bjhp->bhpn", w, bq, xq)


def phase_ssd_kernels(dev) -> float:
    """K4, every route that can take each case, against its plain version
    (the exact recurrence) and the model's chunked algebra, both run in fp32
    (``ssd_close``); returns the largest abs error. A planted fault on route
    tc (the last chunk's local state dropped from the final state) must fail
    the check."""
    import torch

    from repro_torch.kernels import ref, ssd_scan
    from repro_torch.models.mamba2 import ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(1357)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, H, P, N, Q in SSD_CASES:
            x, dt, A, Bm, Cm = ssd_inputs(gen, dev, dtype, B, S, H, P, N)
            wants = (("ssd_ref", fp32_ssd(ref.ssd_ref, x, dt, A, Bm, Cm)),
                     ("ssd_chunked", fp32_ssd(ssd_chunked, x, dt, A, Bm, Cm, Q)))
            for i, route in enumerate(ssd_routes(x, Bm, Cm, Q)):
                y, h = (ssd_scan.ssd_scan(x, dt, A, Bm, Cm, chunk=Q) if i == 0
                        else ssd_scan.launch(x, dt, A, Bm, Cm, Q, route))
                torch.cuda.synchronize()
                for what, (wy, wh) in wants:
                    ey, ry = ssd_close(y, wy)
                    eh, rh = ssd_close(h, wh)
                    worst = max(worst, ey, eh)
                    ok = y.shape == wy.shape and h.shape == wh.shape and max(ry, rh) <= 1
                    log(f"[kernels] ssd_scan {name:50s} {str(dtype):14s} route {route:3s}"
                        f"{' (its own)' if i == 0 else ' (forced)':10s} vs {what:11s} "
                        f"(fp32) y max_abs_err={ey:.3e} at {ry:.3f} of its tolerance, "
                        f"h max_abs_err={eh:.3e} at {rh:.3f} (|y|max "
                        f"{wy.abs().max().item():.3g}, |h|max {wh.abs().max().item():.3g}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"ssd_scan disagrees with {what}: {name}, "
                                             f"{dtype}, route {route}")
                if (dtype == torch.bfloat16 and route == "tc"
                        and name == SSD_PLANTED_FAULT_CASE):
                    # a planted fault the check must catch: the final state
                    # less the last chunk's local state, which is what a
                    # state pass that dropped it would write
                    bad = h - last_chunk_state(x, dt, A, Bm, Q)
                    for what, (wy, wh) in wants:
                        eh, rh = ssd_close(bad, wh)
                        tol = 1e-4 * wh.abs() + 1e-4 * max(1.0, wh.abs().max().item())
                        over = int(((bad - wh).abs() > tol).sum())
                        log(f"[kernels] ssd_scan {name:50s} planted fault, route tc: the "
                            f"last chunk's local state dropped, vs {what}: h max_abs_err="
                            f"{eh:.3e} at {rh:.3f} of its tolerance, {over} of "
                            f"{wh.numel()} states over it: "
                            f"{'FAIL, as it must' if rh > 1 else 'passes: NOT CAUGHT'}")
                        if rh <= 1:
                            raise AssertionError(f"K4's check does not catch a dropped "
                                                 f"chunk state at {name}")
                    del bad
                del y, h
            del x, dt, A, Bm, Cm, wants
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

    from repro_torch.kernels import moe_gmm, ops

    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(E, C, D, generator=gen, device=dev).bfloat16()
    w = (torch.randn(E, D, F, generator=gen, device=dev) / D ** 0.5).bfloat16()
    row = {"route": moe_gmm._route(x, w),
           "ms": time_ms(lambda: ops.moe_gmm(x, w), flush),
           "plain_ms": time_ms(lambda: plain_gmm(x, w), flush, 10, warmup=2),
           "library_ms": time_ms(lambda: torch.bmm(x, w), flush)}
    row["bound_ms"], row["bound_by"] = gmm_bound(E, C, D, F)
    row["shape"] = f"E={E} C={C} D={D} F={F} bf16, x [E,C,D] contiguous"
    return row


def ssd_bound(B, S, H, P, N, Q, es, rate="bfloat16"):
    """The least time of the scan: x, dt, A, B, C read and y, h written once;
    the chunk algebra's operations with the causal halves skipped and C B^T
    counted once a chunk (it does not depend on the head), at the peak rate
    of ``rate``: "bfloat16" (tensor cores) for route tc, "float32" (CUDA
    cores) for route fwd."""
    nc = S // Q
    moved = (2 * B * S * H * P * es + B * S * H * 4 + H * 4 + 2 * B * S * N * es
             + B * H * P * N * 4)
    tri = Q * (Q + 1) // 2
    flops = B * nc * (2 * tri * N + H * (2 * tri * P + 4 * Q * N * P))
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), flops, moved


def time_ssd_shape(dev, flush, B, S, H, P, N, Q):
    """K4 on the route it takes (tc) and on route fwd forced, its plain
    version (the exact recurrence) and the model's chunked algebra at one
    shape: bf16 x, B, C and fp32 dt, A, model layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref, ssd_scan

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(B, S, H, P, generator=gen, device=dev).bfloat16()
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.exp(torch.randn(H, generator=gen, device=dev) * 0.3)
    Bm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5).bfloat16()
    Cm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5).bfloat16()
    row = {"route": ssd_scan._route(x, Bm, Cm, Q),
           "ms": time_ms(lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q), flush, 20),
           "fwd_ms": time_ms(lambda: ssd_scan.launch(x, dt, A, Bm, Cm, Q, "fwd"),
                             flush, 20),
           "plain_ms": time_ms(lambda: ref.ssd_ref(x, dt, A, Bm, Cm), flush, 2, warmup=1),
           "chunked_ms": time_ms(lambda: ops.plain_ssd_scan(x, dt, A, Bm, Cm, Q), flush, 5,
                                 warmup=1),
           "library_ms": None}
    (row["bound_ms"], row["bound_by"]), flops, moved = ssd_bound(B, S, H, P, N, Q, 2)
    (row["bound_ms_fwd"], row["bound_by_fwd"]), _, _ = ssd_bound(B, S, H, P, N, Q, 2,
                                                                 "float32")
    row["shape"] = (f"B={B} S={S} H={H} P={P} N={N} Q={Q}, bf16 x/B/C, fp32 dt/A, "
                    f"model layout; plain = ref.ssd_ref (the O(S) recurrence)")
    row["bound_note"] = (f"{moved / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
                         f"{flops / 1e9:.2f} GFLOP at {PEAK_FLOPS['bfloat16'] / 1e12:.0f} "
                         f"TFLOP/s bf16 (route tc) or {PEAK_FLOPS['float32'] / 1e12:.0f} "
                         f"fp32 (route fwd)")
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
    ok = serve["gmm_routes"] == {"tma_decode": serve["gmm_launches"]}
    log(f"[moe] served {cfg.name}: K3 launches by route {serve['gmm_routes']} "
        f"(want all {serve['gmm_launches']} in tma_decode) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the served decode's K3 calls left the decode kernel")

    # the forward through make_prefill_step
    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev,
                       with_labels=False)
    step = make_prefill_step(model, sharder)
    torch.cuda.synchronize()
    flash_attention.flash_attention_fwd.launches = 0
    moe_gmm.moe_gmm.launches = 0
    moe_gmm.moe_gmm.route_launches = dict.fromkeys(moe_gmm.moe_gmm.route_launches, 0)
    logits = step(params, batch)
    torch.cuda.synchronize()
    k2 = flash_attention.flash_attention_fwd.launches
    k3 = moe_gmm.moe_gmm.launches
    k3_routes = {r: n for r, n in moe_gmm.moe_gmm.route_launches.items() if n}
    finite = bool(torch.isfinite(logits).all())
    ok = (tuple(logits.shape) == (B, S, cfg.vocab) and finite
          and k2 == cfg.n_layers and k3 == 3 * n_moe and k3_routes == {"tma": k3})
    log(f"[moe] forward {cfg.name} B={B} S={S} {cfg.compute_dtype}: logits "
        f"{tuple(logits.shape)}, finite {finite}; flash_attention launches {k2} "
        f"(want {cfg.n_layers}), moe_gmm launches {k3} (want 3 x {n_moe}, all "
        f"in route tma: {k3_routes}) {'ok' if ok else 'FAIL'}")
    del logits

    # a. every K3 and K2 call of the forward against its plain version
    with checked_gmm(TOL["bfloat16"]) as found, \
            checked_prefill_attention(TOL["bfloat16"]) as found2:
        step(params, batch)
    gmm_err = max(e.item() for e, _ in found)
    good = len(found) == 3 * n_moe and max(x.item() for _, x in found) <= 0
    log(f"[moe] a. {cfg.name} bf16 K3 calls of the forward against the plain "
        f"version on the model's inputs: {len(found)} calls, max_abs_err="
        f"{gmm_err:.3e} (tol 2e-2 + 2e-2 relative) {'ok' if good else 'FAIL'}")
    ok &= good
    attn_err = max(e.item() for e, _ in found2)
    good = len(found2) == cfg.n_layers and max(x.item() for _, x in found2) <= 0
    log(f"[moe] a. {cfg.name} bf16 K2 calls (D={cfg.hd}) of the forward against "
        f"the plain version on the model's inputs: {len(found2)} calls, "
        f"max_abs_err={attn_err:.3e} (tol 2e-2 + 2e-2 relative + 2^-8 sum_j "
        f"p_j |v_j|) {'ok' if good else 'FAIL'}")
    ok &= good
    del found, found2

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

    # timings at the main paths' shapes: gate/up and down, prefill (B=4
    # rows of capacity 241) and served decode (4 slots of capacity 4)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    rows = {"decode": time_gmm_shape(dev, flush, E, 16, D, Fd),
            "decode_down": time_gmm_shape(dev, flush, E, 16, Fd, D),
            "prefill": time_gmm_shape(dev, flush, E, B * 241, D, Fd),
            "prefill_down": time_gmm_shape(dev, flush, E, B * 241, Fd, D)}
    for tag, row in rows.items():
        log(f"[timing] moe_gmm {tag} shape ({row['shape']}): route {row['route']} "
            f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms="
            f"{row['library_ms']:.6f} (torch.bmm, yardstick) bound_ms="
            f"{row['bound_ms']:.6f} ({row['bound_by']}); "
            f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound")
    step_ms, plain_step_ms = time_engine_step(dev, cfg, params, steps=15,
                                              plain=plain_moe)
    log(f"[timing] full-width {cfg.name} decode step B=4: {step_ms:.3f} ms with "
        f"K1 and K3, {plain_step_ms:.3f} ms with their plain versions; engine "
        f"{serve['tok_per_s']:.1f} generated tok/s over {serve['steps']} steps in "
        f"{serve['wall_s']:.3f} s")
    busy, launches, (k1_ms, k3_ms, dec_ms) = profile_steps(
        dev, cfg, params, keys=("flash_decode_", "gmm_", GMM_KERNELS["tma_decode"]))
    all_in_kernel(f"full-width {cfg.name} decode step", "K3 (gmm_*)", k3_ms, dec_ms,
                  GMM_KERNELS["tma_decode"])
    log(f"[profile] full-width {cfg.name} decode step B=4 (torch.profiler, 3 "
        f"steps): device busy {busy:.3f} ms a step ({busy / step_ms * 100:.1f}% of "
        f"the {step_ms:.3f} ms step, idle {100 - busy / step_ms * 100:.1f}%); "
        f"{launches:.0f} kernel launches a step; moe_gmm {k3_ms:.3f} ms a step "
        f"({k3_ms / busy * 100:.1f}% of device time), flash_decode {k1_ms:.3f} ms "
        f"({k1_ms / busy * 100:.1f}%)")
    run = {"model": model, "params": params, "batch": batch}
    fwd_ms, plain_fwd_ms = time_forward(dev, run, iters=3, plain=plain_moe)
    busy, launches, (k2_ms, k3_ms, tma_ms, gmm_tma_ms) = profile_forward(
        run, keys=("flash_fwd_", "gmm_", FLASH_TMA, GMM_KERNELS["tma"]))
    k2_share = all_in_kernel(f"full-width {cfg.name} forward", "K2 (flash_fwd_*)",
                             k2_ms, tma_ms, FLASH_TMA)
    all_in_kernel(f"full-width {cfg.name} forward", "K3 (gmm_*)", k3_ms, gmm_tma_ms,
                  GMM_KERNELS["tma"])
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
            "serve_k3_routes": serve["gmm_routes"], "fwd_k3_routes": k3_routes,
            "fwd_k2": k2, "fwd_k3": k3, "gmm_err": gmm_err, "attn_err": attn_err,
            "rows": rows,
            "k2_share": k2_share}


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
    ssd_scan.ssd_scan.route_launches = dict.fromkeys(ssd_scan.ROUTES, 0)
    logits = step(params, batch)
    torch.cuda.synchronize()
    k4 = ssd_scan.ssd_scan.launches
    k4_routes = dict(ssd_scan.ssd_scan.route_launches)
    finite = bool(torch.isfinite(logits).all())
    ok = (tuple(logits.shape) == (B, S, cfg.vocab) and finite and k4 == cfg.n_layers
          and k4_routes["tc"] == cfg.n_layers)
    log(f"[ssm] forward {cfg.name} B={B} S={S} {cfg.compute_dtype}: logits "
        f"{tuple(logits.shape)}, finite {finite}; ssd_scan launches {k4} (want "
        f"n_layers {cfg.n_layers}), by route {k4_routes} (want all on tc) "
        f"{'ok' if ok else 'FAIL'}")
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

    # served as smollm and deepseek are, on the same bf16 weights: each
    # admitted request starts from a fresh state (LM.reset_slot); no K1
    serve = phase_serve(dev, cfg, params=params)
    serve.pop("params")

    row = time_ssd_shape(dev, flush, B, S, H, cfg.ssm_head_dim, cfg.ssm_state,
                         cfg.ssm_chunk)
    log(f"[timing] ssd_scan ({row['shape']}): kernel_ms={row['ms']:.6f} (route "
        f"{row['route']}) fwd_ms={row['fwd_ms']:.6f} (route fwd forced, "
        f"{row['fwd_ms'] / row['ms']:.2f}x) plain_ms={row['plain_ms']:.6f} chunked_ms="
        f"{row['chunked_ms']:.6f} (the model's chunked algebra) library_ms=n/a (no "
        f"single PyTorch call) bound_ms={row['bound_ms']:.6f} ({row['bound_by']}) for "
        f"route tc, {row['bound_ms_fwd']:.6f} ({row['bound_by_fwd']}) for route fwd "
        f"({row['bound_note']}); route tc at {row['bound_ms'] / row['ms'] * 100:.1f}% "
        f"of its bound, route fwd at {row['bound_ms_fwd'] / row['fwd_ms'] * 100:.1f}%")
    run = {"model": model, "params": params, "batch": batch}
    fwd_ms, plain_fwd_ms = time_forward(dev, run, iters=3, plain=plain_ssm)
    busy, launches, (k4_ms, tc_ms) = profile_forward(run, keys=(SSD_ANY, SSD_KERNELS["tc"]))
    k4_share = all_in_kernel(f"full-width {cfg.name} forward", f"K4 ({SSD_ANY}*)", k4_ms,
                             tc_ms, f"route tc ({SSD_KERNELS['tc']}*)")
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
        f"({busy / step_ms * 100:.1f}%), {launches:.0f} kernel launches a step; "
        f"engine {serve['tok_per_s']:.1f} generated tok/s over {serve['steps']} "
        f"steps in {serve['wall_s']:.3f} s")
    log(f"[ssm] peak device memory of the {cfg.name} phase: "
        f"{gb(torch.cuda.max_memory_allocated())}")
    if not ok:
        raise AssertionError("the SSM path failed its checks")
    return {"fwd_k4": k4, "fwd_k4_routes": k4_routes, "ssd_err": ssd_err, "row": row,
            "k4_share": k4_share}


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
    # the ring's edges: S off its 32-step tile, W off its 64 channels, one tile
    ("ring edges B2 S45 W200", 2, 45, 200, ("float32", "bfloat16")),
    ("ring edges B1 S70 W136", 1, 70, 136, ("float32", "bfloat16")),
    ("one tile B1 S32 W64", 1, 32, 64, ("float32", "bfloat16")),
    ("recurrentgemma-9b B4 S2048 W4096", 4, 2048, 4096, ("float32", "bfloat16")),
]
# the gated entry (r, i, x -> a, b in the kernel) at the CPU tests' shapes and
# recurrentgemma-9b's full width; the model's calls are bf16
RGLRU_GATED_CASES = [
    ("test_kernels B2 S128 W256", 2, 128, 256, ("float32", "bfloat16")),
    ("ring edges B2 S45 W200", 2, 45, 200, ("float32", "bfloat16")),
    ("ring edges B1 S70 W136", 1, 70, 136, ("float32", "bfloat16")),
    ("one tile B1 S32 W64", 1, 32, 64, ("float32", "bfloat16")),
    ("ring edges B3 S1 W8", 3, 1, 8, ("float32", "bfloat16")),
    ("recurrentgemma-9b B4 S2048 W4096", 4, 2048, 4096, ("float32", "bfloat16")),
]
# where phase 2 plants a fault on the ring that the check must catch: the
# carry into the last tile dropped (the first entry in fp32, the gated in bf16)
RGLRU_PLANTED_FAULT_CASE = "recurrentgemma-9b B4 S2048 W4096"


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


def gated_inputs(gen, dev, dtype, B, S, W):
    """The gated entry's inputs, as the CPU tests draw them: r, i =
    sigmoid(N(0,1)) and x = N(0,1) in ``dtype``, views of one wider buffer;
    log_a_base = log sigmoid(0.5 N(0,1)) (lambda at the specs' init) and
    h0 = N(0,1), fp32."""
    import torch
    import torch.nn.functional as F

    rix = torch.randn(B, S, 3 * W, generator=gen, device=dev)
    rix[..., :2 * W].sigmoid_()
    rix = rix.to(dtype)
    lab = F.logsigmoid(0.5 * torch.randn(W, generator=gen, device=dev))
    h0 = torch.randn(B, W, generator=gen, device=dev)
    return rix[..., :W], rix[..., W:2 * W], rix[..., 2 * W:], lab, h0


def rglru_close(y, h, wy, wh, tol):
    """(max abs error, within tolerance) of K5's y and h against its plain
    version, elementwise at rtol = atol = tol."""
    import torch

    err = max((y.float() - wy.float()).abs().max().item(), (h - wh).abs().max().item())
    ok = (y.shape == wy.shape and y.dtype == wy.dtype
          and torch.allclose(y.float(), wy.float(), rtol=tol, atol=tol)
          and torch.allclose(h, wh, rtol=TOL["float32"], atol=TOL["float32"]))
    return err, ok


def rglru_routes(a, b) -> list[str]:
    """Every K5 route that can take a call of the first entry: the one
    ``rglru_scan._route`` picks first, then "fwd" forced where it picked
    "ring" ("fwd" takes any call, "ring" only its alignment)."""
    from repro_torch.kernels import rglru_scan

    main = rglru_scan._route(a, b)
    return [main] + (["fwd"] if main == "ring" else [])


def dropped_last_carry(streams, h0, y, lab=None):
    """What a ring that dropped the carry into its last tile would return:
    y with the last tile's steps scanned from 0, and that scan's final
    state (the gated entry's when ``lab`` is given)."""
    import torch

    from repro_torch.kernels import build, ref

    T = build.cu_constant("rglru_scan", "RING_T")
    t0 = (y.shape[1] - 1) // T * T
    tail = [s[:, t0:] for s in streams]
    zeros = torch.zeros_like(h0)
    yt, ht = (ref.rglru_ref(*tail, zeros) if lab is None
              else ref.rglru_gated_ref(*tail, lab, zeros))
    bad = y.clone()
    bad[:, t0:] = yt
    return bad, ht


def phase_rglru_kernels(dev) -> dict:
    """K5 against its plain versions: the first entry through every route
    that can take each case against the exact recurrence, the gated entry
    against ``ref.rglru_gated_ref``; returns the largest abs error of each
    entry and dtype. A planted fault on the ring (the carry into the last
    tile dropped) must fail the check, for each entry at full width."""
    import torch

    from repro_torch.kernels import ref, rglru_scan

    gen = torch.Generator(device=dev).manual_seed(9753)
    worst = {}

    def held(what, name, dname, y, h, want, tol, planted=None):
        err, ok = rglru_close(y, h, *want, tol)
        worst[what] = max(worst.get(what, 0.0), err)
        log(f"[kernels] {what:30s} {name:34s} {dname:9s} max_abs_err={err:.3e} tol={tol:g} "
            f"(+{tol:g} relative; h at fp32 tol) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version: {what}, {name}, "
                                 f"{dname}")
        if planted is not None:
            bad, bh = planted
            err, ok = rglru_close(bad, bh, *want, tol)
            over = int(((bad.float() - want[0].float()).abs()
                        > tol + tol * want[0].float().abs()).sum())
            log(f"[kernels] {what:30s} {name:34s} {dname:9s} planted fault on the ring: "
                f"the carry into the last tile dropped: max_abs_err={err:.3e}, {over} of "
                f"{bad.numel()} outputs over the tolerance: "
                f"{'passes: NOT CAUGHT' if ok else 'FAIL, as it must'}")
            if ok:
                raise AssertionError(f"K5's check does not catch a dropped carry: {what}")

    for name, B, S, W, dtypes in RGLRU_CASES:
        for dname in dtypes:
            a, b, h0 = rglru_inputs(gen, dev, getattr(torch, dname), B, S, W)
            want = ref.rglru_ref(a, b, h0)
            for n, route in enumerate(rglru_routes(a, b)):
                y, h = rglru_scan.rglru_scan(a, b, h0) if n == 0 else rglru_scan.launch(
                    a, b, h0, route)
                torch.cuda.synchronize()
                plant = (route == "ring" and dname == "float32"
                         and name == RGLRU_PLANTED_FAULT_CASE)
                held(f"rglru_scan route {route}{'' if n == 0 else ' (forced)'}", name,
                     dname, y, h, want, TOL[dname],
                     dropped_last_carry((a, b), h0, y) if plant else None)
                del y, h
            del a, b, h0, want
    for name, B, S, W, dtypes in RGLRU_GATED_CASES:
        for dname in dtypes:
            r, i, x, lab, h0 = gated_inputs(gen, dev, getattr(torch, dname), B, S, W)
            want = ref.rglru_gated_ref(r, i, x, lab, h0)
            y, h = rglru_scan.rglru_gated(r, i, x, lab, h0)
            torch.cuda.synchronize()
            plant = dname == "bfloat16" and name == RGLRU_PLANTED_FAULT_CASE
            held("rglru_gated route ring", name, dname, y, h, want, TOL[dname],
                 dropped_last_carry((r, i, x), h0, y, lab) if plant else None)
            del r, i, x, lab, h0, want, y, h
    return worst


def plain_hybrid():
    """Every kernel of the hybrid path (K1, K2, K5's gated entry) as its
    plain version."""
    from repro_torch.kernels import ref

    return plain_ops(flash_decode=plain_decode, flash_attention=plain_flash,
                     rglru_gated=ref.rglru_gated_ref)


@contextlib.contextmanager
def checked_rglru():
    """Run K5's gated entry (the model's) and, on the same inputs, its plain
    version at every scan; yields (max abs err, within tolerance) per call,
    by ``rglru_close``: y at its dtype's TOL, h at fp32's."""
    from repro_torch.kernels import ops, ref

    kernel, found = ops.rglru_gated, []

    def checked(r, i, x, lab, h0):
        y, h = kernel(r, i, x, lab, h0)
        tol = TOL[str(x.dtype).removeprefix("torch.")]
        found.append(rglru_close(y, h, *ref.rglru_gated_ref(r, i, x, lab, h0), tol))
        return y, h

    ops.rglru_gated = checked
    try:
        yield found
    finally:
        ops.rglru_gated = kernel


def rglru_bound(B, S, W, es, gated=False):
    """The least time of the scan: its streams read and y written once
    (``es`` bytes an element: a and b, or gated r, i and x), h0 read and h
    written once in fp32 (and log_a_base when gated); at the fp32 rate one
    FMA an element, and gated 12 operations more (two exps and a sqrt
    counted as one each)."""
    moved = (4 if gated else 3) * B * S * W * es + 2 * B * W * 4 + (W * 4 if gated else 0)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (14 if gated else 2) * B * S * W / PEAK_FLOPS["float32"] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), moved


def unfused_gated(r, i, x, lab, h0, route="fwd"):
    """The model's unfused path on the card, for timing: a and b formed by
    eager fp32 ops (``ref.rglru_decay_input``), h0 folded into the first
    step, K5's first entry on ``route`` from zeros, y cast to x's dtype."""
    import torch

    from repro_torch.kernels import ref, rglru_scan

    a, b = ref.rglru_decay_input(r, i, x, lab)
    b[:, 0] += a[:, 0] * h0
    y, h = rglru_scan.launch(a, b, torch.zeros_like(h0), route)
    return y.to(x.dtype), h


def time_rglru_shape(dev, flush, B, S, W):
    """K5 at one shape. The first entry in fp32 (a and b as the unfused model
    formed them) on the route it takes (the ring) and on route fwd forced,
    its plain version (the step recurrence) and the model's CPU algorithm
    (the doubling scan) run on the card; the gated entry in bf16 (the
    model's call), its plain version, and the unfused model path (a and b by
    eager ops, then route fwd; and then the ring). No single PyTorch call
    computes either."""
    import torch

    from repro_torch.kernels import ops, ref, rglru_scan
    from repro_torch.models.rglru import associative_scan

    gen = torch.Generator(device=dev).manual_seed(10)
    a, b, h0 = rglru_inputs(gen, dev, torch.float32, B, S, W)
    a, b = a.contiguous(), b.contiguous()
    row = {"route": rglru_scan._route(a, b),
           "ms": time_ms(lambda: ops.rglru(a, b, h0), flush),
           "fwd_ms": time_ms(lambda: rglru_scan.launch(a, b, h0, "fwd"), flush),
           "plain_ms": time_ms(lambda: ref.rglru_ref(a, b, h0), flush, 5, warmup=1),
           "scan_ms": time_ms(lambda: associative_scan(a, b), flush, 5, warmup=1),
           "library_ms": None}
    (row["bound_ms"], row["bound_by"]), moved = rglru_bound(B, S, W, 4)
    row["shape"] = (f"B={B} S={S} W={W} fp32 a/b/y, contiguous; plain = "
                    f"ref.rglru_ref (the step recurrence)")
    row["bound_note"] = f"{moved / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s"
    del a, b
    r, i, x, lab, h0 = (t.contiguous() for t in gated_inputs(gen, dev, torch.bfloat16,
                                                             B, S, W))
    g = {"ms": time_ms(lambda: ops.rglru_gated(r, i, x, lab, h0), flush),
         "plain_ms": time_ms(lambda: ref.rglru_gated_ref(r, i, x, lab, h0), flush, 5,
                             warmup=1),
         "unfused_fwd_ms": time_ms(lambda: unfused_gated(r, i, x, lab, h0), flush, 20),
         "unfused_ring_ms": time_ms(lambda: unfused_gated(r, i, x, lab, h0, "ring"),
                                    flush, 20),
         "library_ms": None}
    (g["bound_ms"], g["bound_by"]), moved = rglru_bound(B, S, W, 2, gated=True)
    g["shape"] = (f"B={B} S={S} W={W} bf16 r/i/x/y, contiguous; plain = "
                  f"ref.rglru_gated_ref (eager gate math, the step recurrence)")
    g["bound_note"] = f"{moved / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s"
    row["gated"] = g
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
    rglru_scan.rglru_scan.route_launches = dict.fromkeys(
        rglru_scan.rglru_scan.route_launches, 0)
    logits = step(params, batch)
    torch.cuda.synchronize()
    k2 = flash_attention.flash_attention_fwd.launches
    k5 = rglru_scan.rglru_scan.launches
    k5_routes = dict(rglru_scan.rglru_scan.route_launches)
    finite = all(bool(torch.isfinite(row).all()) for row in logits)
    ok = (tuple(logits.shape) == (B, S, cfg.vocab) and finite
          and k2 == n_attn and k5 == n_rec == k5_routes["gated ring"])
    log(f"[hybrid] forward {cfg.name} B={B} S={S} {cfg.compute_dtype}: logits "
        f"{tuple(logits.shape)}, finite {finite}; flash_attention launches {k2} "
        f"(want {n_attn}), rglru_scan launches {k5} (want {n_rec}, all through the "
        f"gated entry on the ring): {k5_routes} {'ok' if ok else 'FAIL'}")
    del logits

    # a. every K5 and K2 call of the forward against its plain version
    with checked_rglru() as found5, \
            checked_prefill_attention(TOL["bfloat16"]) as found2:
        step(params, batch)
    rglru_err = max(e for e, _ in found5)
    good = len(found5) == n_rec and all(held for _, held in found5)
    log(f"[hybrid] a. {cfg.name} K5 calls of the forward (the gated entry) against "
        f"ref.rglru_gated_ref on the model's r, i and x: {len(found5)} calls, "
        f"max_abs_err={rglru_err:.3e} (y at the {cfg.compute_dtype} tol "
        f"{TOL[cfg.compute_dtype]:g} + {TOL[cfg.compute_dtype]:g} relative, h at "
        f"fp32's {TOL['float32']:g}) {'ok' if good else 'FAIL'}")
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
        with checked_attention(k1_limit) as found1:
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
        f"{dec_err:.3e} (limit {K1_LIMIT_TEXT}) {'ok' if good else 'FAIL'}")
    ok &= good
    ok &= logits_close(got, want, f"d. {cfg.name} {cfg.compute_dtype} decode logits "
                       f"at all {prompt} positions, conditioned weights, K1 vs the "
                       f"plain attention, each through its own cache", "hybrid")
    del got, want, found1
    if not ok:
        raise AssertionError("the hybrid path failed its checks")

    # served as deepseek is (each admitted request starts from a fresh
    # state, LM.reset_slot): K1 = 12 x engine steps; then again with every
    # K1 call held against the plain version. On the `conditioned` weights
    # of c and d (the same tensors but wq, wk, wv): under the specs' init
    # recurrentgemma's attention scores reach ~1,500 (wk and wv take KV = 1
    # as their fan-in), and at two near-tied slots the plain version's own
    # fp32 error moves an output by more than K1's limit (PERF.md section
    # 7; `python src/repro_torch/launch/k1_probe.py witness`)
    serve = phase_serve(dev, cfg, params=cond)
    serve.pop("params")
    phase_serve(dev, cfg, params=cond, checked=True).pop("params")
    del cond

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
    log(f"[timing] rglru_scan ({r['shape']}): kernel_ms={r['ms']:.6f} (route "
        f"{r['route']}) fwd_ms={r['fwd_ms']:.6f} (route fwd forced) "
        f"plain_ms={r['plain_ms']:.6f} scan_ms={r['scan_ms']:.6f} (the model's "
        f"doubling scan) library_ms=n/a (no single PyTorch call) bound_ms="
        f"{r['bound_ms']:.6f} ({r['bound_by']}: {r['bound_note']}); "
        f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound on route {r['route']}, "
        f"{r['bound_ms'] / r['fwd_ms'] * 100:.1f}% on route fwd")
    g = r["gated"]
    log(f"[timing] rglru_gated ({g['shape']}): kernel_ms={g['ms']:.6f} (route ring) "
        f"plain_ms={g['plain_ms']:.6f} unfused_fwd_ms={g['unfused_fwd_ms']:.6f} (the "
        f"unfused model path: eager gate math, route fwd, cast) unfused_ring_ms="
        f"{g['unfused_ring_ms']:.6f} (the same on the ring) library_ms=n/a bound_ms="
        f"{g['bound_ms']:.6f} ({g['bound_by']}: {g['bound_note']}); "
        f"{g['bound_ms'] / g['ms'] * 100:.1f}% of the bound")
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
        log(f"[timing] flash_decode recurrentgemma {tag} ({r['shape']}): "
            f"{decode_row_text(r)}")
    run = {"model": model, "params": params, "batch": batch}
    fwd_ms, plain_fwd_ms = time_forward(dev, run, iters=3, plain=plain_hybrid)
    busy, launches, (k2_ms, k5_ms, tma_ms, ring_ms) = profile_forward(
        run, keys=("flash_fwd_", RGLRU_ANY, FLASH_TMA, RGLRU_KERNELS["ring"]))
    k2_share = all_in_kernel(f"full-width {cfg.name} forward", "K2 (flash_fwd_*)",
                             k2_ms, tma_ms, FLASH_TMA)
    k5_share = all_in_kernel(f"full-width {cfg.name} forward", f"K5 ({RGLRU_ANY}*)",
                             k5_ms, ring_ms, RGLRU_KERNELS["ring"])
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
        f"time); engine {serve['tok_per_s']:.1f} generated tok/s over "
        f"{serve['steps']} steps in {serve['wall_s']:.3f} s")
    log(f"[hybrid] peak device memory of the {cfg.name} phase: "
        f"{gb(torch.cuda.max_memory_allocated())}")
    return {"fwd_k2": k2, "fwd_k5": k5, "fwd_k5_routes": k5_routes, "dec_k1": k1,
            "serve_k1": serve["launches"], "rglru_err": rglru_err, "attn_err": attn_err,
            "rows": rows, "k2_share": k2_share, "k5_share": k5_share,
            "k5_ms": k5_ms}


# --------------------------------------------------------------------------- #
# the VLM family: qwen2-vl-7b
# --------------------------------------------------------------------------- #
VLM_PREFIX, VLM_GRID = 128, (32, 56)  # text tokens, then image patch rows x columns


def vlm_positions(dev, B, S):
    """[3,B,S] M-RoPE streams (temporal, h, w) of a Qwen2-VL prompt: a text
    prefix of VLM_PREFIX tokens (the three streams equal), an image of
    VLM_GRID patches (t constant, h the row, w the column, each from the
    prefix's length), and a text suffix that continues from the largest
    position + 1. Every row gets the same layout."""
    import torch

    prefix, (gh, gw) = VLM_PREFIX, VLM_GRID
    assert prefix + gh * gw < S, (prefix, VLM_GRID, S)
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=dev)  # noqa: E731
    start = prefix + max(gh, gw)
    suffix = start + ar(S - prefix - gh * gw)
    streams = [torch.cat([ar(prefix), img, suffix]) for img in (
        torch.full((gh * gw,), prefix, dtype=torch.int32, device=dev),
        prefix + ar(gh).repeat_interleave(gw),
        prefix + ar(gw).repeat(gh))]
    return torch.stack(streams)[:, None, :].repeat(1, B, 1)


def decode_streams(dev, B, T):
    """[3,B,T] streams for the decode-vs-prefill check: stream 0 ``arange``
    (the decode cache keys its ring on it), streams 1 and 2 distinct from
    it and from each other."""
    import torch

    s = torch.arange(T, dtype=torch.int32, device=dev)
    return torch.stack([s, s // 32, s % 32 + 7])[:, None, :].repeat(1, B, 1)


def phase_vlm(dev, flush, *, B=4, S=2048, steps=64, max_len=512):
    """qwen2-vl-7b at full width: its forward on patch embeddings with
    Qwen2-VL's M-RoPE streams (K2) and its decode step on [B,1,Din]
    embeddings with [3,B] positions (K1), every kernel call against its
    plain version, the forward's logits against the plain attention's, the
    teacher-forced decode against the prefill; timings."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch.inputs import conditioned, make_batch
    from repro_torch.models.base import init_tree, param_count
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import make_prefill_step, make_serve_step

    t_phase = time.perf_counter()
    cfg = get_arch("qwen2_vl_7b")
    model, sharder = build_model(cfg), Sharder(None)
    L = cfg.n_layers
    log(f"[vlm] config {cfg.name}: {L}L d_model {cfg.d_model} H {cfg.n_heads} KV "
        f"{cfg.n_kv_heads} (G={cfg.n_heads // cfg.n_kv_heads}) hd {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, qkv bias {cfg.qkv_bias}, rope_theta "
        f"{cfg.rope_theta:g}, M-RoPE sections {cfg.mrope_sections} (pairs), "
        f"{cfg.frontend} frontend {cfg.frontend_dim}")
    torch.cuda.reset_peak_memory_stats()
    # the config's fp32 weights (read by the fp32 reading of c) and their
    # bf16 compute copy: ~42.5 GB, which leaves the phase room on the card
    params32 = init_tree(torch.Generator(device=dev).manual_seed(0),
                         model.param_specs(), cfg.param_dtype, dev)
    # conditioned: attention scores O(1), as in a trained model (phase 6 b)
    params = conditioned(cfg, model.compute_params(params32))
    torch.cuda.synchronize()
    log(f"[vlm] {cfg.name}: {param_count(model.param_specs()) / 1e9:.2f} B params "
        f"drawn in {cfg.param_dtype} with a {cfg.compute_dtype} compute copy, "
        f"conditioned: {gb(torch.cuda.memory_allocated())} on the card, peak "
        f"{gb(torch.cuda.max_memory_allocated())}")

    # the forward: make_batch's embeddings, Qwen2-VL's position layout (its
    # three equal streams would make M-RoPE plain RoPE)
    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev,
                       with_labels=False)
    ok = (tuple(batch["embeds"].shape) == (B, S, cfg.frontend_dim)
          and tuple(batch["positions"].shape) == (3, B, S))
    batch["positions"] = vlm_positions(dev, B, S)
    step = make_prefill_step(model, sharder)
    torch.cuda.synchronize()
    flash_attention.flash_attention_fwd.launches = 0
    logits = step(params, batch)
    torch.cuda.synchronize()
    k2 = flash_attention.flash_attention_fwd.launches
    finite = all(bool(torch.isfinite(row).all()) for row in logits)
    ok &= tuple(logits.shape) == (B, S, cfg.vocab) and finite and k2 == L
    log(f"[vlm] forward {cfg.name} B={B} S={S} {cfg.compute_dtype}, patch "
        f"embeddings [{B},{S},{cfg.frontend_dim}], positions [3,{B},{S}] (text "
        f"{VLM_PREFIX}, image {VLM_GRID[0]} x {VLM_GRID[1]} patches, text): logits "
        f"{tuple(logits.shape)}, finite "
        f"{finite}; flash_attention launches {k2} (want {L}) "
        f"{'ok' if ok else 'FAIL'}")
    del logits

    # a. every K2 call of the forward against the plain version
    with checked_prefill_attention(TOL["bfloat16"]) as found2:
        step(params, batch)
    attn_err = max(e.item() for e, _ in found2)
    good = len(found2) == L and max(x.item() for _, x in found2) <= 0
    log(f"[vlm] a. {cfg.name} bf16 K2 calls (D={cfg.hd}, G="
        f"{cfg.n_heads // cfg.n_kv_heads}) of the forward against the plain "
        f"version on the model's inputs: {len(found2)} calls, max_abs_err="
        f"{attn_err:.3e} (tol 2e-2 + 2e-2 relative + 2^-8 sum_j p_j |v_j|) "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    del found2

    # b. logits with K2 against the plain attention
    got = step(params, batch)
    with plain_prefill_attention():
        want = step(params, batch)
    ok &= logits_close(got, want, f"b. {cfg.name} bf16 logits of all {B * S} "
                       f"tokens, K2 vs plain attention", "vlm")
    del got, want

    # c. `steps` teacher-forced decode steps through make_serve_step on the
    # forward's first embeddings, [3,B] positions a step: every K1 call
    # against the plain version, and the logits against the prefill of the
    # same embeddings and streams (K2)
    streams = decode_streams(dev, B, steps)                       # [3,B,T]
    emb = batch["embeds"][:, :steps]                              # [B,T,Din]
    positions = streams.permute(2, 0, 1).contiguous()             # [T,3,B]

    def decode(p, m=model, c=cfg, x=emb):
        serve = make_serve_step(m, sharder)
        cache = fresh_cache(c, B, max_len, dev)
        out = []
        for t in range(steps):
            lg, cache = serve(p, cache, x[:, t:t + 1], positions[t])
            out.append(lg.float())
        return torch.stack(out, dim=1)                            # [B,T,V]

    def prefill(p, m=model, x=emb):
        return make_prefill_step(m, sharder)(p, {"embeds": x, "positions": streams})

    pre = prefill(params)
    decode_attention.flash_decode.launches = 0
    with checked_attention(k1_limit) as found1:
        dec = decode(params)
    k1 = decode_attention.flash_decode.launches
    dec_err = max(e.item() for e, _ in found1)
    good = len(found1) == k1 == L * steps and max(x.item() for _, x in found1) <= 0
    log(f"[vlm] c. {cfg.name} bf16 K1 calls (D={cfg.hd}, G="
        f"{cfg.n_heads // cfg.n_kv_heads}, cache max_len {max_len}) of {steps} "
        f"teacher-forced decode steps x B={B} ([{B},1,{cfg.frontend_dim}] "
        f"embeddings, [3,{B}] positions) against the plain version on the model's "
        f"inputs: {len(found1)} calls, {k1} launches (want {L} x {steps}), "
        f"max_abs_err={dec_err:.3e} (limit {K1_LIMIT_TEXT}) "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    del found1
    ok &= logits_close(pre, dec, f"c. {cfg.name} bf16 logits at all {steps} "
                       f"positions, prefill (K2) vs teacher-forced decode (K1), "
                       f"streams 0: arange, 1: s // 32, 2: s % 32 + 7", "vlm")
    # readings beside c: the same comparison with K1 and K2 both plain, and
    # in fp32 (the config's weights, conditioned; the kernels' fp32 routes)
    with plain_ops(flash_decode=plain_decode, flash_attention=plain_flash):
        plain_gap = logits_gap(prefill(params), decode(params))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32)
    p32 = conditioned(cfg32, params32)
    gap32 = logits_gap(prefill(p32, model32, emb.float()),
                       decode(p32, model32, cfg32, emb.float()))
    del p32
    kernel_gap = logits_gap(pre, dec)
    log(f"[vlm] c. readings, prefill vs decode max_abs_err (largest |logit|, "
        f"argmax agreement): bf16 with K1 and K2 {kernel_gap[0]:.3e} "
        f"({kernel_gap[1]:.3f}, {kernel_gap[2] * 100:.2f}%), bf16 with both plain "
        f"{plain_gap[0]:.3e} ({plain_gap[1]:.3f}, {plain_gap[2] * 100:.2f}%), fp32 "
        f"with K1 and K2 {gap32[0]:.3e} ({gap32[1]:.3f}, {gap32[2] * 100:.2f}%)")
    del pre, dec
    if not ok:
        raise AssertionError("the VLM path failed its checks")

    # timings
    rows = {"flash": time_flash_shape(dev, flush, B, S, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.hd, True),
            "decode": time_decode_shape(dev, flush, B, cfg.n_heads, cfg.n_kv_heads,
                                        max_len, cfg.hd)}
    r = rows["flash"]
    log(f"[timing] flash_attention qwen2-vl shape ({r['shape']}): kernel_ms="
        f"{r['ms']:.6f} plain_ms={r['plain_ms']:.6f} library_ms="
        f"{r['library_ms']:.6f} (scaled_dot_product_attention, yardstick) bound_ms="
        f"{r['bound_ms']:.6f} ({r['bound_by']}); "
        f"{r['bound_ms'] / r['ms'] * 100:.1f}% of the bound")
    log(f"[timing] flash_decode qwen2-vl shape ({rows['decode']['shape']}): "
        f"{decode_row_text(rows['decode'])}")
    run = {"model": model, "params": params, "batch": batch}
    fwd_ms, plain_fwd_ms = time_forward(dev, run, iters=3)
    busy, launches, (k2_ms, tma_ms) = profile_forward(
        run, keys=("flash_fwd_", FLASH_TMA))
    k2_share = all_in_kernel(f"full-width {cfg.name} forward", "K2 (flash_fwd_*)",
                             k2_ms, tma_ms, FLASH_TMA)
    log(f"[timing] full-width {cfg.name} forward B={B} S={S}: {fwd_ms:.3f} ms with "
        f"K2 ({B * S / fwd_ms * 1e3:.0f} tok/s), {plain_fwd_ms:.3f} ms with the "
        f"plain attention")
    log(f"[profile] full-width {cfg.name} forward (torch.profiler, one forward): "
        f"device busy {busy:.3f} ms ({busy / fwd_ms * 100:.1f}% of {fwd_ms:.3f} ms); "
        f"{launches} kernel launches; flash_attention {k2_ms:.3f} ms "
        f"({k2_ms / busy * 100:.1f}% of device time, {k2_ms / L:.3f} ms a call)")
    step_ms, plain_step_ms = time_engine_step(dev, cfg, params, B=B, steps=15)
    busy, launches, (k1_ms,) = profile_steps(dev, cfg, params, B=B)
    log(f"[timing] full-width {cfg.name} decode step B={B} (cache max_len 512, "
        f"[{B},1,{cfg.frontend_dim}] embeddings, [3,{B}] positions): {step_ms:.3f} "
        f"ms with K1, {plain_step_ms:.3f} ms with the plain attention; device busy "
        f"{busy:.3f} ms a step ({busy / step_ms * 100:.1f}%, idle "
        f"{100 - busy / step_ms * 100:.1f}%), {launches:.0f} kernel launches a step, "
        f"flash_decode {k1_ms:.3f} ms ({k1_ms / busy * 100:.1f}% of device time)")
    log(f"[vlm] peak device memory of the {cfg.name} phase: "
        f"{gb(torch.cuda.max_memory_allocated())}; phase time "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"fwd_k2": k2, "dec_k1": k1, "attn_err": attn_err, "dec_err": dec_err,
            "rows": rows, "k2_share": k2_share}


# --------------------------------------------------------------------------- #
# gradients through the kernels (phase 12) and the Trainer (phase 13)
# --------------------------------------------------------------------------- #
#: phase 12's bound on max |g_kernel - g_plain| of a gradient leaf, as a
#: share of the leaf's largest |g_plain| (PERF.md §6): fp32 ten
#: times the kernels' fp32 TOL (two layers to carry a forward difference
#: through), bf16 the forward's own limit on logits, 2e-2 of the largest
GRAD_BOUND = {"float32": 1e-3, "bfloat16": 2e-2}
#: phase 12's paths: config and the layers it keeps (full width, cut depth:
#: deepseek its dense layer and one MoE layer, recurrentgemma one
#: superblock and one tail block)
GRAD_PATHS = (("smollm_360m", 2), ("deepseek_moe_16b", 2), ("mamba2_2_7b", 2),
              ("recurrentgemma_9b", 4))


def kernel_counters() -> dict:
    """The launch counter of each kernel a forward can take (K2–K5)."""
    from repro_torch.kernels import flash_attention, moe_gmm, rglru_scan, ssd_scan

    return {"flash_attention": flash_attention.flash_attention_fwd,
            "moe_gmm": moe_gmm.moe_gmm, "ssd_scan": ssd_scan.ssd_scan,
            "rglru_scan": rglru_scan.rglru_scan}


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def forward_launches(cfg) -> dict:
    """Each kernel's launches in one forward: K2 one an attention layer, K3
    three an MoE layer, K4 one a mamba2 layer, K5 one a recurrent block."""
    want = dict.fromkeys(kernel_counters(), 0)
    if cfg.family == "moe":
        want["flash_attention"] = cfg.n_layers
        want["moe_gmm"] = 3 * (cfg.n_layers - cfg.first_k_dense)
    elif cfg.family == "ssm":
        want["ssd_scan"] = cfg.n_layers
    elif cfg.family == "hybrid":
        want["flash_attention"] = cfg.n_layers // 3
        want["rglru_scan"] = cfg.n_layers - cfg.n_layers // 3
    else:
        want["flash_attention"] = cfg.n_layers
    return want


def named_leaves(tree):
    """[(path, leaf)] in sorted-key order (``tree_leaves``' order), the
    paths as checkpoints name them."""
    from repro_torch.ckpt.checkpoint import _flatten

    return list(_flatten(tree).items())


def loss_grads(model, params, batch):
    """The training loss (``train.step._loss_fn``) and autograd's gradient
    of every leaf of ``params`` (None where the loss does not reach it)."""
    import torch

    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import _loss_fn

    leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
    loss, _ = _loss_fn(model, Sharder(None), params, batch)
    return loss.item(), torch.autograd.grad(loss, leaves, allow_unused=True)


def grads_held(names, got, want, bound):
    """(the leaves that fail, the worst max|g - g_plain| / (bound ·
    max|g_plain|), its leaf): a leaf fails with no gradient, a non-finite
    or an all-zero one, or one off the plain path's by more than the
    bound."""
    import torch

    bad, worst, where = [], 0.0, ""
    for name, g, w in zip(names, got, want):
        if g is None or not bool(torch.isfinite(g).all()) or not bool(g.ne(0).any()):
            bad.append(name)
            continue
        ratio = ((g.float() - w.float()).abs().max()
                 / (bound * w.float().abs().max())).item()
        if ratio > worst:
            worst, where = ratio, name
        if not ratio <= 1:
            bad.append(name)
    return bad, worst, where


def detached_k2(q, k, v, *, causal=True, window=None):
    """K2 as the port called it before its autograd.Function: the kernel's
    output with no gradient (phase 12's planted fault)."""
    import torch

    from repro_torch.kernels import ops

    with torch.no_grad():
        return ops._flash(q, k, v, causal, window)


def phase_grads(dev, *, B=2, S=512):
    """Loss and backward at full width, cut depth, through the kernels and
    then through their plain paths (``ops.PLAIN``), in fp32 and in the
    configs' bf16: every leaf's gradient held to the plain path's
    (``GRAD_BOUND``), each kernel's launches = its forward's x 2 (full
    remat), and K2's old detached output planted, which must fail on wq,
    wk and wv. Returns the launches by path and the worst ratios."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.inputs import conditioned, make_batch
    from repro_torch.models.base import init_tree, param_count
    from repro_torch.models.registry import build_model

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    by_path, worst_by_path, ok = {name: {} for name in kernel_counters()}, {}, True
    for arch, n_layers in GRAD_PATHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                                      compute_dtype=dtype)
            model = build_model(cfg)
            params = conditioned(cfg, init_tree(
                torch.Generator(device=dev).manual_seed(0), model.param_specs(),
                cfg.param_dtype, dev))
            batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1),
                               dev)
            names = [n for n, _ in named_leaves(params)]
            chosen = []
            torch.cuda.synchronize()
            zero_counts()
            with routing(record=chosen):
                loss_k, got = loss_grads(model, params, batch)
            torch.cuda.synchronize()
            counts = read_counts()
            with plain_ops(**ops.PLAIN), routing(replay=chosen):
                loss_p, want = loss_grads(model, params, batch)
            torch.cuda.synchronize()
            plain_counts = read_counts()
            fwd = forward_launches(cfg)
            bad, worst, where = grads_held(names, got, want, GRAD_BOUND[dtype])
            launches_ok = (counts == {k: 2 * n for k, n in fwd.items()}
                           and plain_counts == counts)
            path = f"{cfg.name} {n_layers}L gradients {dtype}"
            good = not bad and launches_ok and abs(loss_k - loss_p) <= 2e-2 * abs(loss_p)
            log(f"[grads] {path} ({param_count(model.param_specs()) / 1e9:.2f} B params, "
                f"B={B} S={S}, remat {cfg.remat}): loss {loss_k:.6f} with the kernels, "
                f"{loss_p:.6f} plain; {len(names)} leaves, every gradient present, "
                f"finite and nonzero {'yes' if not bad else 'NO: ' + ', '.join(bad)}; "
                f"worst max|g - g_plain| {worst:.3f} of the bound ({GRAD_BOUND[dtype]:g} "
                f"x the leaf's largest |g_plain|) at {where}; launches "
                f"{ {k: v for k, v in counts.items() if v} } (want 2 x the forward's "
                f"{ {k: v for k, v in fwd.items() if v} }; none more in the plain run) "
                f"{'ok' if good else 'FAIL'}")
            ok &= good
            worst_by_path[path] = worst
            for name, n in counts.items():
                if n:
                    by_path[name][path] = n

            if arch == "smollm_360m" and dtype == "float32":
                with plain_ops(flash_attention=detached_k2):
                    _, planted = loss_grads(model, params, batch)
                caught, _, _ = grads_held(names, planted, want, GRAD_BOUND[dtype])
                need = {f"layers/attn/{w}" for w in ("wq", "wk", "wv")}
                good = need <= set(caught)
                log(f"[grads] planted fault, K2's output detached (the port before "
                    f"its autograd.Function) on {path}: the check fails on "
                    f"{', '.join(caught)} (must include {', '.join(sorted(need))}) "
                    f"{'ok' if good else 'FAIL'}")
                ok &= good
                del planted
            del params, batch, got, want
            gc.collect()
            torch.cuda.empty_cache()
    log(f"[grads] phase time {time.perf_counter() - t_phase:.1f} s; peak device "
        f"memory {gb(torch.cuda.max_memory_allocated())}")
    if not ok:
        raise AssertionError("the gradients through the kernels failed their checks")
    return {"by_path": by_path, "worst": worst_by_path}


def params_apart(got, want, lr_sum, tight_lr):
    """(max |got - want|, the share of elements off by more than 1e-5
    relative + 1e-3 x ``tight_lr``) over two param trees."""
    worst, off, n = 0.0, 0, 0
    for (_, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
        d = (a.detach().float() - b.detach().float()).abs()
        worst = max(worst, d.max().item())
        off += int((d > 1e-5 * b.detach().float().abs() + 1e-3 * tight_lr).sum())
        n += d.numel()
    return worst, off / n


def phase_train(dev, flush, *, steps=10, global_batch=8, seq_len=2048,
                microbatches=2, stop_at=6):
    """Full-width, full-depth smollm-360m trained by the port's Trainer on
    the synthetic stream: an uninterrupted run, a run that stops at
    ``stop_at`` (a checkpoint there), and one that resumes it to ``steps``;
    checks, then step time, tokens/s, the model-flops share, a profile of
    one step, the plain attention backward's share and checkpoint times."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import SyntheticLMDataset, to_tensors
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models.base import init_tree, param_count
    from repro_torch.models.registry import build_model
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    cfg = get_arch("smollm_360m")
    kw = dict(steps=steps, global_batch=global_batch, seq_len=seq_len,
              microbatches=microbatches, ckpt_every=stop_at, keep=1, warmup=2,
              peak_lr=1e-3, seed=0)
    tokens = global_batch * seq_len
    k2_step = cfg.n_layers * 2 * microbatches  # a forward and a remat recompute
    n_params = param_count(build_model(cfg).param_specs())
    log(f"[train] {cfg.name}: {cfg.n_layers}L d_model {cfg.d_model}, "
        f"{n_params / 1e6:.1f} M params ({cfg.param_dtype}, {cfg.compute_dtype} "
        f"compute, remat {cfg.remat}, {cfg.optimizer}); TrainerConfig({kw}); "
        f"{tokens} tokens a step in {microbatches} microbatches")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ok = True
    with tempfile.TemporaryDirectory() as d:
        runs = {}
        for tag, ckpt_dir, resume, stop in (("uninterrupted", None, False, None),
                                            ("stopped", d, False, stop_at),
                                            ("resumed", d, True, None)):
            if tag == "resumed":  # the checkpoint's restore and save, timed
                target = Trainer(cfg, TrainerConfig(**kw), device=dev).init_state()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                back = restore_checkpoint(d, stop_at, target)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                save_checkpoint(back, d, stop_at, keep=1)
                save_s = time.perf_counter() - t0
                del target, back
            trainer = Trainer(cfg, TrainerConfig(ckpt_dir=ckpt_dir, **kw), device=dev)
            torch.cuda.synchronize()
            flash_attention.flash_attention_fwd.launches = 0
            state = trainer.run(resume=resume, stop_at=stop)
            torch.cuda.synchronize()
            k2 = flash_attention.flash_attention_fwd.launches
            done = len(trainer.metrics_log)
            good = k2 == k2_step * done and int(state["step"]) == (stop or steps)
            log(f"[train] {tag} run: steps {trainer.metrics_log[0]['step']}.."
                f"{trainer.metrics_log[-1]['step']}, losses "
                f"{[round(m['loss'], 4) for m in trainer.metrics_log]}; K2 launches "
                f"{k2} (want {cfg.n_layers} layers x 2 (remat) x {microbatches} "
                f"microbatches x {done} steps = {k2_step * done}) "
                f"{'ok' if good else 'FAIL'}")
            ok &= good
            if tag == "stopped":
                good = latest_step(d) == stop_at
                log(f"[train] checkpoint after the stopped run: step {latest_step(d)} "
                    f"(want {stop_at}) {'ok' if good else 'FAIL'}")
                ok &= good
                del state
            else:
                runs[tag] = (trainer, state)
            gc.collect()
            torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()

    trainer, state = runs["uninterrupted"]
    losses = [m["loss"] for m in trainer.metrics_log]
    good = (all(map(math.isfinite, losses))
            and statistics.mean(losses[-3:]) < losses[0])
    log(f"[train] uninterrupted losses finite and the mean of the last 3 "
        f"({statistics.mean(losses[-3:]):.4f}) below the first ({losses[0]:.4f}) "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    init = init_tree(torch.Generator(device=dev).manual_seed(kw["seed"]),
                     trainer.model.param_specs(), cfg.param_dtype, dev)
    moved = {name: a.detach().ne(b).float().mean().item() for (name, a), (_, b)
             in zip(named_leaves(state["params"]), named_leaves(init))}
    good = min(moved.values()) > 0
    least = min(moved, key=moved.get)
    log(f"[train] every parameter leaf updated by the 10 steps: "
        f"{sum(v > 0 for v in moved.values())} of {len(moved)} leaves moved; the "
        f"least, {least}, in {moved[least] * 100:.2f}% of its elements "
        f"{'ok' if good else 'FAIL'}")
    ok &= good
    del init
    lrs = [warmup_cosine(s, peak_lr=kw["peak_lr"], warmup=kw["warmup"],
                         total=steps).item() for s in range(steps)]
    worst, share = params_apart(runs["resumed"][1]["params"], state["params"],
                                sum(lrs), kw["peak_lr"])
    good = worst <= 2 * sum(lrs) and share < 1e-2
    log(f"[train] resumed run's params against the uninterrupted run's: max |diff| "
        f"{worst:.3e} (bound 2 x the sum of the 10 steps' lr, {2 * sum(lrs):.3e}: an "
        f"update of the other sign every step), {share * 100:.4f}% of elements off by "
        f"more than 1e-5 relative + 1e-3 x peak lr (bound 1%: the atomic sums of the "
        f"embedding's backward may run in another order, and AdamW resolves no sign "
        f"where a gradient is within its rounding of 0) {'ok' if good else 'FAIL'}")
    ok &= good
    del runs["resumed"]
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the training path failed its checks")

    walls = [m["wall_s"] for m in trainer.metrics_log]
    step_ms = statistics.median(walls[1:]) * 1e3
    mfu = 6 * n_params * tokens / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"[timing] {cfg.name} train step (global batch {global_batch} x {seq_len}, "
        f"{microbatches} microbatches, remat full): median {step_ms:.3f} ms of steps "
        f"2..{steps} (first {walls[0] * 1e3:.3f} ms; all {[round(w * 1e3, 1) for w in walls]}); "
        f"{tokens / step_ms * 1e3:.0f} tok/s; 6 N tokens / step time = "
        f"{mfu * 100:.2f}% of {PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s (N = "
        f"{n_params / 1e6:.1f} M)")
    batch = to_tensors(SyntheticLMDataset(cfg, global_batch=global_batch,
                                          seq_len=seq_len).batch_at(steps), dev)
    state, _ = trainer._step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, metrics = trainer._step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
    busy_ms, launches, (k2_ms,) = device_totals(prof, "flash_fwd_")
    log(f"[profile] {cfg.name} train step (torch.profiler, one step): device busy "
        f"{busy_ms:.3f} ms ({busy_ms / step_ms * 100:.1f}% of the {step_ms:.3f} ms "
        f"step); {launches} kernel launches; flash_attention (K2, forward and "
        f"recompute) {k2_ms:.3f} ms ({k2_ms / busy_ms * 100:.2f}% of device time)")
    del state, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # the plain attention backward (K2's Function.backward: the chunked
    # path's forward and backward) at the step's shape, one layer and
    # microbatch a call
    mb = global_batch // microbatches
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(mb, seq_len, h, D, generator=gen, device=dev)
               .to(torch.bfloat16).requires_grad_(True) for h in (H, KV, KV))
    g = torch.randn(mb, seq_len, H, D, generator=gen, device=dev).to(torch.bfloat16)
    bwd = lambda: torch.autograd.grad(ops.plain_flash_attention(q, k, v), (q, k, v), g)
    bwd_ms = time_ms(bwd, flush, iters=5, warmup=1)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: ops.flash_attention(q, k, v), flush, iters=20)
    calls = cfg.n_layers * microbatches
    log(f"[timing] plain attention backward at B={mb} S={seq_len} H={H} KV={KV} "
        f"D={D} causal bf16: {bwd_ms:.3f} ms a call, x {calls} calls = "
        f"{bwd_ms * calls:.1f} ms a step, {bwd_ms * calls / step_ms * 100:.1f}% of "
        f"the step; K2's forward at that shape {fwd_ms:.6f} ms")
    log(f"[train] peak device memory of the training runs {gb(peak)}; checkpoint "
        f"of params, m and v ({gb(3 * 4 * n_params)}): save {save_s:.2f} s, restore "
        f"{restore_s:.2f} s (to the card); phase time "
        f"{time.perf_counter() - t_phase:.1f} s")
    del q, k, v, g
    return {"k2": k2_step * steps, "step_ms": step_ms, "bwd_ms": bwd_ms}


# --------------------------------------------------------------------------- #
# phase 14: distribution
# --------------------------------------------------------------------------- #
#: phase 14a's memory band, (low, high factor, high slack bytes): the card's
#: peak over the traced peak (PERF.md §6: the allocator never holds less
#: than the live storages; above them it adds unsplit segment tails, up to
#: 1 MiB a live block over 1 MiB, cuBLAS workspaces and kernel temporaries)
MEM_BAND = (0.97, 1.10, 256 * 2 ** 20)
#: phase 14's run: global batch, sequence, microbatches a rank, ranks
DIST_RUN = {"global_batch": 8, "seq_len": 2048, "microbatches": 2, "ranks": 2}


def local(x):
    """A DTensor's full value on this rank (its placements are replicas),
    or a plain tensor, detached."""
    from repro_torch.runtime.sharding import is_dtensor

    return (x.full_tensor() if is_dtensor(x) else x).detach()


def microbatch_grads(model, params, batch, k):
    """(mean gradient over ``k`` microbatches in fp32, summed in
    make_train_step's order; the mean of |g| over them), plain tensors."""
    import torch

    from repro_torch.models.base import tree_leaves, tree_unflatten
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import _loss_fn, _split_microbatches

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    acc = absum = None
    for mb in _split_microbatches(batch, k):
        loss, _ = _loss_fn(model, Sharder(None), params, mb)
        g = [t.float() for t in torch.autograd.grad(loss, leaves)]
        if acc is None:
            acc = [t.clone() for t in g]
            absum = [t.abs() for t in g]
        else:
            for a, b, t in zip(acc, absum, g):
                a.add_(t)
                b.add_(t.abs())
        del g, loss
    for p in leaves:
        p.requires_grad_(False)
    for a, b in zip(acc, absum):
        a.div_(k)
        b.div_(k)
    return tree_unflatten(params, acc), tree_unflatten(params, absum)


def dp_bounds(state0, grad, absum, lr, *, terms):
    """Elementwise bounds on |data-parallel - single-process| for the
    params, m and v after one AdamW step from ``state0`` (PERF.md §6).

    The two steps run the same microbatches through the same kernels at
    the same shapes; only the fp32 sum of the ``terms`` microbatch
    gradients runs in another order: two ranks' partial sums, then the
    all-reduce (off the exact sum by at most 2u sum|g_j|, u = 2^-24),
    against the sequential sum (at most (terms - 1) u sum|g_j|). After
    the mean the two differ by at most (terms + 1) u mean|g_j|, inside
    ``delta = (terms + 2) u · mean|g_j|``. AdamW is run at grad ± delta
    from the same state: twice the
    larger move of each element, plus two fp32 ulps of the update's
    operands, bounds the step's difference. Returns {"params"|"m"|"v":
    [bound leaves]}.""" 
    import copy

    import torch

    from repro_torch.models.base import tree_leaves, tree_map, tree_unflatten
    from repro_torch.optim.optimizers import adamw_update

    u = 2.0 ** -24
    delta = [(terms + 2) * u * a * 1.01 for a in tree_leaves(absum)]
    keys = ("params", "m", "v")

    def step_at(sign):
        """params, m, v (leaf lists) after AdamW from state0 at grad +
        sign * delta; copies, so state0 stays as it is."""
        st = copy.deepcopy(state0["opt"])
        p = tree_map(lambda t: t.detach().clone(), state0["params"])
        g = tree_unflatten(grad, [gi + sign * d for gi, d in
                                  zip(tree_leaves(grad), delta)])
        p, st = adamw_update(g, st, p, lr=lr)
        del g
        return {"params": tree_leaves(p), "m": tree_leaves(st["m"]),
                "v": tree_leaves(st["v"])}

    # one endpoint at a time, the bound kept in the first one's storage:
    # three copies of the state at most (the card holds both ranks)
    mid = step_at(0.0)
    bound = None
    for sign in (1.0, -1.0):
        end = step_at(sign)
        for key in keys:
            for i, (e, m) in enumerate(zip(end[key], mid[key])):
                e.sub_(m).abs_()
                if bound is not None:
                    torch.maximum(bound[key][i], e, out=bound[key][i])
        if bound is None:
            bound = end
        del end
    # the fp32 rounding of each update, at the scale of its operands (p -
    # lr step cancels where p is near lr: an ulp of p, not of the result)
    eps = torch.finfo(torch.float32).eps
    old = {"params": tree_leaves(state0["params"]), "m": tree_leaves(state0["opt"]["m"]),
           "v": tree_leaves(state0["opt"]["v"])}
    for key in keys:
        for b, m, o, g in zip(bound[key], mid[key], old[key], tree_leaves(grad)):
            extra = {"params": abs(float(lr)), "m": g.abs(), "v": g.square()}[key]
            b.mul_(2).add_(2 * eps * (m.abs() + o.abs() + extra)).add_(1e-30)
    return bound


def leaf_names(tree, prefix=""):
    """The leaves' key paths in sorted-key order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def held(got_state, want_state, bounds) -> dict:
    """{key: (worst |got - want| / bound, leaves over)} for params, m, v."""
    from repro_torch.models.base import tree_leaves

    out = {}
    for key, g, w in (("params", got_state["params"], want_state["params"]),
                      ("m", got_state["opt"]["m"], want_state["opt"]["m"]),
                      ("v", got_state["opt"]["v"], want_state["opt"]["v"])):
        worst, over = 0.0, 0
        for name, a, b, lim in zip(leaf_names(g), tree_leaves(g), tree_leaves(w),
                                   bounds[key]):
            r = ((local(a).detach().float() - b.detach().float()).abs() / lim).max().item()
            worst = max(worst, r)
            if r > 1:
                over += 1
                log(f"[dist] {key} {name}: |dp - one| up to {r:.3e} x its bound")
        out[key] = (worst, over)
    return out


def _dist_rank(rank, n, dev, opts) -> dict:
    """Phase 14b on one rank (see ``dist_child``): GPipe and the compressed
    all-reduce on the initial weights, then the data-parallel step checked
    against one process, a timed one, and the step from a checkpoint
    restored onto the mesh. Rank 0 runs the single-process references
    (each in place on its own copy, so the card holds both ranks)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs.base import get_arch, get_smoke
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.inputs import batch_axes, make_batch
    from repro_torch.models.base import (abstract_tree, axes_tree, init_tree,
                                         shardings_tree, tree_leaves, tree_map,
                                         tree_unstack)
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import dense_block_fwd
    from repro_torch.runtime.dist import compressed_psum
    from repro_torch.runtime.pipeline import gpipe_forward
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = (get_smoke if opts["smoke"] else get_arch)(opts["arch"])
    B, S, k = opts["global_batch"], opts["seq_len"], opts["microbatches"]
    model = build_model(cfg)
    specs = model.param_specs()
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    params0 = init_tree(gen(0), specs, cfg.param_dtype, dev)
    batch = make_batch(cfg, B, S, gen(1), dev)
    mesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("data",))
    sharder = Sharder(mesh).with_rules({"embed": ()})
    step_kw = dict(peak_lr=1e-3, warmup=0, total_steps=10)
    dp_step = make_train_step(model, sharder, microbatches=k, **step_kw)
    one_step = make_train_step(model, Sharder(None), microbatches=k * n, **step_kw)
    dbatch = sharder.place_tree(batch_axes(cfg, with_labels=True), batch)
    out = {"rank": rank, "batch_spec": {key: str(x.placements) for key, x in dbatch.items()}}
    k2 = flash_attention.flash_attention_fwd
    good = True

    # --- GPipe: the layers as n stages, 4 microbatches
    n_micro = 4
    per = cfg.n_layers // n
    stage = tree_map(lambda t: t[rank * per:(rank + 1) * per], params0["layers"])
    pos = batch["positions"][:B // n_micro]

    def stage_fn(p, x):
        for lp in tree_unstack(p):
            x = dense_block_fwd(lp, cfg, Sharder(None), x, pos, mode="causal",
                                window=cfg.swa_window)
        return x

    with torch.inference_mode():
        h0 = model._embed_in(params0, batch, Sharder(None))
        mbs = h0.reshape(n_micro, B // n_micro, *h0.shape[1:])
        stats = {}
        k2.launches = 0
        piped = gpipe_forward(None, stage_fn, stage, mbs, stats=stats)
        out["gpipe"] = {**stats, "k2": k2.launches}
        if rank == 0:
            whole = torch.stack([stage_fn(params0["layers"], x) for x in mbs])
            diff = (piped.float() - whole.float()).abs()
            lim = TOL["bfloat16"] + TOL["bfloat16"] * whole.float().abs()
            out["gpipe_diff"] = diff.max().item()
            out["gpipe_ratio"] = (diff / lim).max().item()
            good &= out["gpipe_ratio"] <= 1
            del whole, diff, lim
        del h0, mbs, piped, stage

    # --- the compressed all-reduce over this rank's gradient share
    lo, hi = rank * B // n, (rank + 1) * B // n
    mine = {key: (x[:, lo:hi] if key == "positions" and x.ndim == 3 else x[lo:hi])
            for key, x in batch.items()}
    gmine, gabs = microbatch_grads(model, params0, mine, k)
    del gabs
    leaves = [g.div_(n) for g in tree_leaves(gmine)]
    sync()
    t0 = time.perf_counter()
    exact = []
    for g in leaves:
        e = g.clone()
        dist.all_reduce(e)
        exact.append(e)
    sync()
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    comp = [compressed_psum(g) for g in leaves]
    sync()
    comp_s = time.perf_counter() - t0
    worst = 0.0
    for g, e, c in zip(leaves, exact, comp):
        amax = g.abs().amax()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX)
        scale = torch.clamp_min(amax / 127.0, 1e-12)
        lim = n * scale / 2 + 2.0 ** -22 * (e.abs() + c.abs())
        worst = max(worst, ((c - e).abs() / lim).max().item())
    out.update(exact_allreduce_s=exact_s, compressed_allreduce_s=comp_s,
               compressed_worst=worst, grad_bytes=sum(g.numel() * 4 for g in leaves))
    good &= worst <= 1
    del gmine, leaves, exact, comp

    axes = axes_tree(specs)
    state_axes = {"step": None, "params": axes,
                  "opt": {"m": axes, "v": axes, "count": None}}

    def placed(state):
        """A plain train state (copied) as the mesh's DTensors."""
        return sharder.place_tree(state_axes, tree_map(lambda t: t.clone(), state))

    def dp_from(dstate):
        """The data-parallel step from ``dstate`` (DTensors): K2 launches,
        the new state, the loss, seconds."""
        sync()
        k2.launches = 0
        t0 = time.perf_counter()
        dstate, m = dp_step(dstate, dbatch)
        loss = local(m["loss"]).item()
        sync()
        return k2.launches, dstate, loss, time.perf_counter() - t0

    def check(state0, dstate, dloss, tag):
        """rank 0: the single-process step from ``state0`` on the whole
        batch (in place: ``state0`` becomes its result) against the
        data-parallel one."""
        grad, absum = microbatch_grads(model, state0["params"], batch, k * n)
        lr = warmup_cosine_at(state0["step"], step_kw)
        bounds = dp_bounds(state0, grad, absum, lr, terms=k * n)
        del grad, absum
        want, wm = one_step(state0, batch)
        wloss = wm["loss"].item()
        res = held(dstate, want, bounds)
        loss_ok = abs(dloss - wloss) <= 8 * 2.0 ** -24 * abs(wloss)
        ok = loss_ok and all(over == 0 for _, over in res.values())
        log(f"[dist] rank 0: {tag}: loss {dloss:.7f} against the single process's "
            f"{wloss:.7f} (|diff| {abs(dloss - wloss):.3e}, bound 8u|loss|); worst "
            f"|diff| / bound: params {res['params'][0]:.3e}, m {res['m'][0]:.3e}, "
            f"v {res['v'][0]:.3e}; leaves over: {sum(o for _, o in res.values())} "
            f"{'ok' if ok else 'FAIL'}")
        return ok, {key: r[0] for key, r in res.items()}

    # --- the data-parallel step, checked; rank 0 then saves the reference
    state0 = init_train_state(model, params0)
    launches, dstate, dloss, _ = dp_from(placed(state0))
    out["k2_dp_step"] = launches
    if rank == 0:
        ok1, out["dp_ratio"] = check(state0, dstate, dloss, "data-parallel step")
        good &= ok1
        out["dp_loss"] = dloss
        save_checkpoint(state0, opts["ckpt"], 1, keep=1)
    del state0, params0
    # --- timed: a second data-parallel step
    _, dstate, _, secs = dp_from(dstate)
    out["step_s"] = secs
    del dstate

    # --- elastic restore: saved by rank 0, restored by both onto the mesh
    dist.barrier()
    placements = shardings_tree(specs, sharder)
    meta = abstract_tree(specs, cfg.param_dtype)
    count = torch.empty((), dtype=torch.int32, device="meta")
    target = {"step": count, "params": meta, "opt": {"m": meta, "v": meta, "count": count}}
    shard_tree = {"step": None, "params": placements,
                  "opt": {"m": placements, "v": placements, "count": None}}
    back = restore_checkpoint(opts["ckpt"], 1, target, shardings=shard_tree, mesh=mesh)
    out["restored_placements"] = str(tree_leaves(back["params"])[0].placements)
    # rank 0's reference: the same checkpoint as plain tensors on the card
    plain_back = (restore_checkpoint(opts["ckpt"], 1, target, mesh=mesh)
                  if rank == 0 else None)
    launches3, dstate3, dloss3, _ = dp_from(back)
    out["k2_elastic_step"] = launches3
    if rank == 0:
        ok3, out["elastic_ratio"] = check(plain_back, dstate3, dloss3,
                                          "data-parallel step from the restored checkpoint")
        good &= ok3
    dist.barrier()
    out["ok"] = bool(good)
    return out


def warmup_cosine_at(step, kw):
    from repro_torch.optim.schedules import warmup_cosine

    return warmup_cosine(step, peak_lr=kw["peak_lr"], warmup=kw["warmup"],
                         total=kw["total_steps"])


def dist_child(rank: int, opts: dict) -> None:
    """One rank of phase 14b, in a process of its own (spawned): a gloo
    group over a file store, ranks on one device, results to
    ``opts["out"]``.<rank>.json."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    dev = torch.device(opts["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    n = opts["ranks"]
    dist.init_process_group("gloo", store=dist.FileStore(opts["store"], n),
                            rank=rank, world_size=n)
    try:
        out = _dist_rank(rank, n, dev, opts)
        Path(f"{opts['out']}.{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def run_ranks(opts: dict) -> list[dict]:
    """Spawn ``opts["ranks"]`` processes of ``dist_child``; their results.
    Raises if a child fails (``start_processes`` joins them all)."""
    import torch.multiprocessing as mp

    mp.start_processes(dist_child, args=(opts,), nprocs=opts["ranks"],
                       start_method="spawn", join=True)
    return [json.loads(Path(f"{opts['out']}.{r}.json").read_text())
            for r in range(opts["ranks"])]


def dry_run_cell() -> dict:
    """Phase 14a's dry run: phase 13's step (smollm-360m, ``DIST_RUN``'s
    batch) traced on a one-card mesh (CPU only, fake tensors)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell

    B, S = DIST_RUN["global_batch"], DIST_RUN["seq_len"]
    t0 = time.perf_counter()
    r = run_cell("smollm_360m", ShapeConfig(f"train_{B}x{S}", S, B, "train"),
                 microbatches=DIST_RUN["microbatches"], probes=False, verbose=False,
                 mesh_shape=((1, 1), ("data", "model")))
    r["wall_s"] = time.perf_counter() - t0
    return r


def start_dry_run(out: Path) -> subprocess.Popen:
    """``dry_run_cell`` in a process of its own (one intra-op thread), its
    result to ``out``: the trace needs only the CPU, so it runs while
    phases 12 and 13 hold the card."""
    code = ("import json, sys, torch; torch.set_num_threads(1); "
            "import chip_smoke; "
            "open(sys.argv[1], 'w').write(json.dumps(chip_smoke.dry_run_cell(), default=str))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    return subprocess.Popen([sys.executable, "-c", code, str(out)], cwd=ROOT, env=env)


def finish_dry_run(proc: subprocess.Popen, out: Path) -> dict:
    if proc.wait(timeout=900) != 0:
        raise AssertionError(f"the dry-run process exited with {proc.returncode}")
    return json.loads(out.read_text())


def phase_distribution(dev, flush, train_step_ms, dry):
    """Phase 14: the dry run held against the card (a), and two ranks on
    the card (b)."""
    import tempfile

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.inputs import make_batch
    from repro_torch.models.base import init_tree
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.sharding import Sharder
    from repro_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    card_text = card()
    cfg = get_arch("smollm_360m")
    run = DIST_RUN
    B, S, k = run["global_batch"], run["seq_len"], run["microbatches"]

    # --- 14a: the dry run of the step on a one-card mesh (``dry``: the
    # ``start_dry_run`` process and its output file)
    t0 = time.perf_counter()
    r = finish_dry_run(*dry)
    waited_s = time.perf_counter() - t0
    if r["status"] != "ok":
        raise AssertionError(f"the dry run of the train step failed: {r.get('error')}")
    flops_pred = r["full"]["cost_raw"]["flops"]
    peak_pred = r["full"]["memory"]["peak_bytes_est"]
    roof = r["roofline"]
    log(f"[dist] 14a: dry run of {cfg.name} train {B} x {S}, {k} microbatches, "
        f"remat {cfg.remat}, on a 1-card mesh: traced in {r['full']['trace_s']:.1f} s "
        f"({r['wall_s']:.1f} s with the fake world; waited {waited_s:.1f} s for it); "
        f"per device {flops_pred:.6e} FLOP, "
        f"{r['full']['cost_raw']['bytes']:.6e} bytes, peak {gb(peak_pred)}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg)
    params = init_tree(torch.Generator(device=dev).manual_seed(0),
                       model.param_specs(), cfg.param_dtype, dev)
    state = init_train_state(model, params)
    batch = make_batch(cfg, B, S, torch.Generator(device=dev).manual_seed(1), dev)
    step = make_train_step(model, Sharder(None), microbatches=k)
    ok = True
    with plain_ops(**ops.PLAIN):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter = FlopCounterMode(display=False)
        with counter:
            state, m = step(state, batch)
            float(m["loss"])
        torch.cuda.synchronize()
        peak_card = torch.cuda.max_memory_allocated() - base
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    flops_card = counter.get_total_flops()
    step_s = min(walls)
    good = flops_card == flops_pred
    log(f"[dist] 14a: FlopCounterMode of the real step (plain ops) {flops_card} FLOP "
        f"against the dry run's {int(flops_pred)} {'ok' if good else 'FAIL'}")
    ok &= good
    good = step_s > roof["step_time_s"]
    log(f"[dist] 14a: plain step {step_s * 1e3:.3f} ms (best of {[round(w * 1e3, 1) for w in walls]}) "
        f"above the roofline's {roof['step_time_s'] * 1e3:.3f} ms ({roof['dominant']}: "
        f"compute {roof['compute_s'] * 1e3:.3f} ms, memory {roof['memory_s'] * 1e3:.3f} ms, "
        f"collective {roof['collective_s'] * 1e3:.3f} ms at H100 rates) "
        f"{'ok' if good else 'FAIL'} [{card_text}]")
    ok &= good
    lo_f, hi_f, slack = MEM_BAND
    good = lo_f * peak_pred <= peak_card <= hi_f * peak_pred + slack
    log(f"[dist] 14a: peak device memory of the step {gb(peak_card)} ({peak_card} B) "
        f"against the dry run's {gb(peak_pred)} ({peak_pred} B): ratio "
        f"{peak_card / peak_pred:.4f}, band [{lo_f}, {hi_f} + {slack // 2 ** 20} MiB] "
        f"{'ok' if good else 'FAIL'} [{card_text}]")
    ok &= good
    share = roof["model_flops"] / (train_step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"[dist] 14a: model_flops_analytic {roof['model_flops']:.6e} FLOP over phase "
        f"13's kernel step ({train_step_ms:.3f} ms) = {share * 100:.3f}% of "
        f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s; useful FLOP ratio "
        f"{roof['useful_flops_ratio']:.4f}; roofline mfu bound {roof['mfu_bound']:.4f} "
        f"[{card_text}]")
    del state, params, batch, m, step, counter
    gc.collect()
    torch.cuda.empty_cache()

    # --- 14b: two ranks on the card
    with tempfile.TemporaryDirectory() as d:
        opts = {"arch": "smollm_360m", "smoke": False, "device": "cuda:0",
                "store": f"{d}/store", "out": f"{d}/rank", "ckpt": f"{d}/ckpt",
                **run}
        t0 = time.perf_counter()
        ranks = run_ranks(opts)
        ranks_s = time.perf_counter() - t0
    n = run["ranks"]
    want_k2 = cfg.n_layers * 2 * k
    for rr in ranks:
        good = (rr["ok"] and rr["k2_dp_step"] == want_k2
                and rr["k2_elastic_step"] == want_k2)
        log(f"[dist] 14b: rank {rr['rank']}: batch {rr['batch_spec']}; K2 launches "
            f"{rr['k2_dp_step']} and {rr['k2_elastic_step']} in the checked steps (want "
            f"{cfg.n_layers} layers x 2 (remat) x {k} microbatches = {want_k2}); "
            f"compressed all-reduce worst {rr['compressed_worst']:.4f} of its bound; "
            f"GPipe {rr['gpipe']}; restored as {rr['restored_placements']} "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    r0 = ranks[0]
    tokens = B * S
    bubble = [1 - rr["gpipe"]["busy_s"] / rr["gpipe"]["wall_s"] for rr in ranks]
    log(f"[dist] 14b: data-parallel step {r0['step_s'] * 1e3:.3f} ms "
        f"({tokens / r0['step_s']:.0f} tok/s over both ranks), worst |dp - one| / "
        f"bound {r0['dp_ratio']}, after the elastic restore {r0['elastic_ratio']}; "
        f"all-reduce of the {gb(r0['grad_bytes'])} gradient: exact "
        f"{r0['exact_allreduce_s'] * 1e3:.3f} ms, int8-grid compressed "
        f"{r0['compressed_allreduce_s'] * 1e3:.3f} ms (gloo through host memory); "
        f"GPipe 2 stages x 4 microbatches over {r0['gpipe']['transport']} "
        f"transport: bubble {[round(b, 4) for b in bubble]} (schedule "
        f"{(n - 1) / (4 + n - 1):.2f}), hidden states |diff| {r0['gpipe_diff']:.3e} "
        f"({r0['gpipe_ratio']:.4f} of the bf16 limit); children {ranks_s:.1f} s "
        f"[{card_text}]")
    if not ok:
        raise AssertionError("the distribution phase failed its checks")
    log(f"[dist] phase time {time.perf_counter() - t_phase:.1f} s")
    return {"k2": sum(rr["k2_dp_step"] + rr["k2_elastic_step"] for rr in ranks),
            "trace_s": r["wall_s"]}


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
    flash_err, flash_planted = phase_flash_kernels(dev)
    gmm_err = phase_gmm_kernels(dev)
    ssd_err = phase_ssd_kernels(dev)
    rglru_err = phase_rglru_kernels(dev)
    serve = phase_serve(dev, cfg)
    params = serve.pop("params")
    multiproc = phase_multiproc(dev, cfg)
    phase_parity(dev, cfg, params)
    prefill = phase_prefill(dev)

    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    B, H, KV, D = 4, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    serve_row = time_decode_shape(dev, flush, B, H, KV, 512, D)
    long_row = time_decode_shape(dev, flush, B, H, KV, 32768, D)
    for tag, row in (("serve", serve_row), ("long", long_row)):
        log(f"[timing] flash_decode {tag} shape ({row['shape']}): "
            f"{decode_row_text(row)}")
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
        "deepseek": time_flash_shape(dev, flush, 4, 2048, 16, 16, 128, True),
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
    k2_share = {}
    for arch, run in prefill["runs"].items():
        fwd_ms, plain_fwd_ms = time_forward(dev, run)
        B, S = run["batch"]["positions"].shape
        busy_ms, launches, (k2_ms, tma_ms) = profile_forward(
            run, keys=("flash_fwd_", FLASH_TMA))
        k2_share[f"{run['cfg'].name} forward"] = all_in_kernel(
            f"full-width {run['cfg'].name} forward", "K2 (flash_fwd_*)", k2_ms,
            tma_ms, FLASH_TMA)
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
    gc.collect()
    torch.cuda.empty_cache()
    vlm = phase_vlm(dev, flush)
    gc.collect()
    torch.cuda.empty_cache()
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dry_"))
    dry = (start_dry_run(dry_dir / "cell.json"), dry_dir / "cell.json")
    try:
        grads = phase_grads(dev)
        gc.collect()
        torch.cuda.empty_cache()
        train = phase_train(dev, flush)
        gc.collect()
        torch.cuda.empty_cache()
        dist = phase_distribution(dev, flush, train["step_ms"], dry)
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        shutil.rmtree(dry_dir, ignore_errors=True)
    log(f"[env] whole run {time.perf_counter() - t_start:.1f} s")

    k1_paths = {"smollm-360m serve": serve["launches"],
                "smollm-360m multi-process serve": multiproc["launches"],
                "deepseek-moe-16b serve": moe["serve_k1"],
                "recurrentgemma-9b serve": hybrid["serve_k1"],
                "recurrentgemma-9b decode": hybrid["dec_k1"],
                "qwen2-vl-7b decode": vlm["dec_k1"]}
    k2_paths = {**prefill["by_path"], "deepseek-moe-16b forward": moe["fwd_k2"],
                "recurrentgemma-9b forward": hybrid["fwd_k2"],
                "qwen2-vl-7b forward": vlm["fwd_k2"],
                "smollm-360m train": train["k2"],
                "smollm-360m data-parallel train, 2 ranks": dist["k2"],
                **grads["by_path"]["flash_attention"]}
    k2_share.update({"deepseek-moe-16b forward": moe["k2_share"],
                     "recurrentgemma-9b forward": hybrid["k2_share"],
                     "qwen2-vl-7b forward": vlm["k2_share"]})
    k3_paths = {"deepseek-moe-16b serve": moe["serve_k3"],
                "deepseek-moe-16b forward": moe["fwd_k3"], **grads["by_path"]["moe_gmm"]}
    k4_paths = {"mamba2-2.7b forward": ssm["fwd_k4"], **grads["by_path"]["ssd_scan"]}
    k5_paths = {"recurrentgemma-9b forward": hybrid["fwd_k5"],
                **grads["by_path"]["rglru_scan"]}
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
        "qwen2_vl": vlm["rows"]["decode"],
    }, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "max_abs_err": flash_err, **{key: rows["smollm"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "planted_fault_elements_over": flash_planted, "tma_share_by_path": k2_share,
        "hubert": rows["hubert"], "long": rows["long"], "deepseek": rows["deepseek"],
        "recurrentgemma": hybrid["rows"]["flash"], "qwen2_vl": vlm["rows"]["flash"],
    }, {
        "name": "moe_gmm", "route": "cuda", "source": GMM_SOURCE,
        "replaces": GMM_REPLACES, "launches": sum(k3_paths.values()),
        "launches_by_path": k3_paths, "max_abs_err": max(gmm_err, moe["gmm_err"]),
        "routes": GMM_KERNELS,
        "route_launches_by_path": {"deepseek-moe-16b serve": moe["serve_k3_routes"],
                                   "deepseek-moe-16b forward": moe["fwd_k3_routes"]},
        **{key: moe["rows"]["decode"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "decode_route": moe["rows"]["decode"]["route"],
        "decode_down": moe["rows"]["decode_down"], "prefill": moe["rows"]["prefill"],
        "prefill_down": moe["rows"]["prefill_down"],
    }, {
        "name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "launches": sum(k4_paths.values()),
        "launches_by_path": k4_paths,
        "routes": SSD_KERNELS,
        "route_launches_by_path": {"mamba2-2.7b forward": ssm["fwd_k4_routes"]},
        "tc_share_by_path": {"mamba2-2.7b forward": ssm["k4_share"]},
        "max_abs_err": max(ssd_err, ssm["ssd_err"]), "main_path_route": ssm["row"]["route"],
        **{key: ssm["row"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "chunked_ms", "fwd_ms", "bound_ms_fwd", "bound_by_fwd")},
    }, {
        # top-level numbers: the gated entry in bf16, the main path's call
        "name": "rglru_scan", "route": "cuda", "source": RGLRU_SOURCE,
        "replaces": RGLRU_REPLACES, "launches": sum(k5_paths.values()),
        "launches_by_path": k5_paths,
        "routes": RGLRU_KERNELS,
        "route_launches_by_path": {"recurrentgemma-9b forward": hybrid["fwd_k5_routes"]},
        "ring_share_by_path": {"recurrentgemma-9b forward": hybrid["k5_share"]},
        "device_ms_by_path": {"recurrentgemma-9b forward": hybrid["k5_ms"]},
        "max_abs_err": max(max(rglru_err.values()), hybrid["rglru_err"]),
        "max_abs_err_by_check": rglru_err,
        **hybrid["rows"]["rglru"]["gated"],
        "first_entry": {key: value for key, value in hybrid["rows"]["rglru"].items()
                        if key != "gated"},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
