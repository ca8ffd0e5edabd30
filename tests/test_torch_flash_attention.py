"""K2 parity: the port's flash_attention_ref and ops.flash_attention (the
plain version on the CPU) against the JAX Pallas kernel in interpret mode
and the JAX oracle, on the same numpy inputs; and, on a CUDA card, the
hand-written kernel against the plain version.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

# tests/test_kernels.py's tolerances: fp32 2e-5, bf16 2e-2 (one bf16
# rounding of outputs of magnitude ~1)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, Sq, Sk, H, KV, D):
    """Model layout: q [B,Sq,H,D]; k, v [B,Sk,KV,D]."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    return q, k, v


CASES = {
    # tests/test_kernels.py:26-51: its shapes, group sizes and masks
    **{f"B{b} H{h} S{s} D{d} G{g} {m}": (b, s, s, h, h // g, d, m != "bidir",
                                         32 if m == "w32" else None)
       for b, h, s, d in ((1, 4, 128, 32), (2, 6, 256, 64), (1, 8, 64, 16))
       for g in (1, 2) for m in ("causal", "w32", "bidir")},
    # tests/test_kernels.py:54-72: S not a multiple of the block
    "S100 non-divisible": (1, 100, 100, 2, 2, 32, True, None),
    # smollm-360m smoke heads: G=3, D=20
    "smollm smoke G3 D20": (2, 40, 40, 3, 1, 20, True, None),
    # h2o-danube head dim with a window that cuts, narrow
    "danube D120 G4 window 48": (1, 150, 150, 8, 2, 120, True, 48),
    # recurrentgemma-9b's local attention, narrow: MQA (G=16), D=256, a
    # window that cuts
    "recurrentgemma D256 G16 window 48": (1, 150, 150, 16, 1, 256, True, 48),
    # the TMA kernel's head dims beside 64 and 256: hubert's D=80
    # (bidirectional) and deepseek's D=128, narrow and not tile multiples
    "hubert D80 bidir S300": (2, 300, 300, 4, 4, 80, False, None),
    "deepseek D128 causal S333": (2, 333, 333, 4, 4, 128, True, None),
    # smollm-360m's G=3 at D=64, long enough that the K/V tiles wrap the
    # kernel's ring of stages several times
    "smollm G3 D64 causal S700": (2, 700, 700, 6, 2, 64, True, None),
}


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_flash_attention_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    B, Sq, Sk, H, KV, D, causal, window = CASES[case]
    q, k, v = _inputs(len(case), B, Sq, Sk, H, KV, D)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    want_kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                       interpret=True)
    want_ref = jnp.swapaxes(jref.flash_attention_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2), jnp.swapaxes(jv, 1, 2),
        causal=causal, window=window), 1, 2)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got_ref = tref.flash_attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                       tv.transpose(1, 2), causal=causal,
                                       window=window).transpose(1, 2)
    assert got.dtype == tdt and got.shape == (B, Sq, H, D)
    tol = TOL[dtype]
    for t in (got, got_ref):
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)


def test_kernel_layout_entry_matches_model_layout():
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 2, 50, 50, 6, 2, 16))
    model = tops.flash_attention(q, k, v, window=20)
    kernel = tfa.flash_attention_fwd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), window=20)
    torch.testing.assert_close(model, kernel.transpose(1, 2), rtol=0, atol=0)


def test_a_row_with_no_visible_key_is_zero():
    # window 0 masks every key: the oracle's where(mask, p, 0) gives 0
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 8, 8, 2, 1, 16))
    out = tops.flash_attention(q, k, v, window=0)
    assert bool((out == 0).all())


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "device", "shape",
                                 "group", "empty", "window"])
def test_flash_attention_rejects_what_the_kernel_cannot_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 16, 16, 4, 2, 8))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "device":
        k = k.to("meta")
    elif bad == "shape":
        v = v[:, :8]
    elif bad == "group":
        q = torch.zeros(1, 16, 3, 8)
    elif bad == "empty":
        q = q[:, :0]
    else:
        kw["window"] = -1
    with pytest.raises((TypeError, ValueError)):
        tops.flash_attention(q, k, v, **kw)


def test_plain_calls_do_not_count_as_launches():
    before = tfa.flash_attention_fwd.launches
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 8, 8, 3, 1, 20))
    tops.flash_attention(q, k, v)
    assert tfa.flash_attention_fwd.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, Sq, Sk, H, KV, D, causal, window = CASES[case]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt).cuda()
               for a in _inputs(len(case), B, Sq, Sk, H, KV, D))
    before = tfa.flash_attention_fwd.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    want = tref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=causal,
                                    window=window).transpose(1, 2)
    # the card sums in another order than the plain version: 1e-4 in fp32
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_bf16_head_dim_the_kernel_lacks_raises():
    """The bf16 kernel is built for D <= 128 and D = 256 only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.zeros(1, 16, 2, 192, dtype=torch.bfloat16, device="cuda")
               for _ in range(3))
    with pytest.raises(ValueError, match="head dim 192"):
        tops.flash_attention(q, k, v)


# --------------------------------------------------------------------------- #
# the routing point and the TMA kernel's tile plan (no card needed)
# --------------------------------------------------------------------------- #
def _model_layout(B, S, H, D, dtype=torch.bfloat16):
    """A [B,H,S,D] view of a [B,S,H,D] tensor, as ops.flash_attention
    hands the model's q, k and v to the kernel."""
    return torch.zeros(B, S, H, D, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("H, KV, D, want", [
    (15, 5, 64, "tma"),     # smollm-360m
    (16, 16, 80, "tma"),    # hubert-xlarge
    (16, 16, 128, "tma"),   # deepseek-moe-16b
    (28, 4, 128, "tma"),    # qwen2-vl-7b
    (16, 1, 256, "tma"),    # recurrentgemma-9b
    (3, 1, 20, "mma"),      # the smoke configs: 40-byte rows
])
def test_route_by_head_dim_and_stride(H, KV, D, want):
    q, k, v = (_model_layout(4, 64, n, D) for n in (H, KV, KV))
    assert tfa._route(q, k, v) == want


def test_route_off_alignment_and_fp32():
    q, k, v = (_model_layout(2, 64, n, 64) for n in (15, 5, 5))
    # a base 2 bytes past 16-byte alignment: TMA cannot take it
    flat = torch.zeros(1 + 2 * 64 * 15 * 64, dtype=torch.bfloat16)
    off = flat[1:].view(2, 64, 15, 64).transpose(1, 2)
    assert off.data_ptr() % 16 == 2
    assert tfa._route(off, k, v) == "mma"
    assert tfa._route(q, k, v) == "tma"
    f32 = [_model_layout(2, 64, n, 64, torch.float32) for n in (15, 5, 5)]
    assert tfa._route(*f32) == "f32"
    with pytest.raises(ValueError, match="head dim 192"):
        tfa._route(*(_model_layout(1, 16, 2, 192) for _ in range(3)))


# the TMA kernel's tile sizes, constants of its source, which the mirror
# below shares with it
_BQ, _BK, _BK_D256, _WG_D64, _WG = (
    build.cu_constant("flash_attention", c)
    for c in ("TMA_BQ", "TMA_BK", "TMA_BK_D256", "TMA_WG_D64", "TMA_WG"))


def _kv_range(qlo, qhi, Sk, causal, window):
    """The keys [lo, hi) that queries qlo..qhi can see (kv_range)."""
    hi = min(Sk, qhi + 1) if causal else Sk
    lo = max(0, qlo - (window - 1)) if window is not None else 0
    return lo, hi


def _edge(k0, bk, qa, qb, Sk, causal, window):
    """Whether the kernel evaluates the mask on a tile (softmax_tile)."""
    return not (k0 + bk <= Sk and (not causal or k0 + bk - 1 <= qa)
                and (window is None or qb - k0 < window))


def _tile_plan(Sq, Sk, G, D, causal, window):
    """A mirror of flash_fwd_tma_wgmma's plan for one KV head: for each
    consumer warpgroup of each CTA, (head in the group, first row, last row,
    [(first key, tile keys, edge), ...] of the tiles it computes)."""
    import math

    nc = _WG_D64 if D <= 64 else _WG
    bk = _BK if D <= 128 else _BK_D256
    gc = math.gcd(G, nc)
    nqb = nc // gc
    plan = []
    for g0 in range(0, G, gc):
        for q0 in range(0, Sq, nqb * _BQ):
            lo, hi = _kv_range(q0, min(q0 + nqb * _BQ, Sq) - 1, Sk, causal, window)
            t_begin = lo // bk
            t_end = -(-hi // bk) if hi > lo else t_begin
            for w in range(nc):
                qa = q0 + (w // gc) * _BQ
                qb = min(qa + _BQ, Sq) - 1
                lt0 = lt1 = t_end
                if qb >= qa:
                    wlo, whi = _kv_range(qa, qb, Sk, causal, window)
                    if whi > wlo:
                        lt0, lt1 = wlo // bk, -(-whi // bk)
                assert t_begin <= lt0 <= lt1 <= t_end
                plan.append((g0 + w % gc, qa, qb, [
                    (t * bk, bk, _edge(t * bk, bk, qa, qb, Sk, causal, window))
                    for t in range(lt0, lt1)]))
    return plan


def _mask(Sq, Sk, causal, window):
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    m = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        m &= qp >= kp
    if window is not None:
        m &= qp - kp < window
    return m


PLAN_CASES = {
    # name: Sq, Sk, G, D, causal, window
    "causal D64 G3": (300, 300, 3, 64, True, None),
    "causal D64 G1 (3 query blocks a CTA)": (200, 200, 1, 64, True, None),
    "bidir D80 G1": (300, 300, 1, 80, False, None),
    "causal D128 Sq<Sk": (150, 333, 1, 128, True, None),
    "causal D128 Sq>Sk": (333, 150, 2, 128, True, None),
    "window 48 D256 G16": (300, 300, 16, 256, True, 48),
    "window 100 bidir D64 G5": (260, 260, 5, 64, False, 100),
    "window 0 D64": (140, 140, 3, 64, True, 0),
    "window 0 bidir D256": (70, 70, 2, 256, False, 0),
}


@pytest.mark.parametrize("case", PLAN_CASES)
def test_tile_plan_visits_each_unmasked_pair_once(case):
    Sq, Sk, G, D, causal, window = PLAN_CASES[case]
    mask = _mask(Sq, Sk, causal, window)
    visits = torch.zeros(G, Sq, Sk, dtype=torch.int32)
    for g, qa, qb, tiles in _tile_plan(Sq, Sk, G, D, causal, window):
        for k0, bk, edge in tiles:
            ka, kb = k0, min(k0 + bk, Sk)
            visits[g, qa:qb + 1, ka:kb] += 1
            if not edge:  # a tile without the mask holds no masked pair
                assert k0 + bk <= Sk and bool(mask[qa:qb + 1, ka:kb].all()), \
                    (case, g, qa, k0)
    assert bool((visits[:, mask] == 1).all()), "an unmasked pair visited != once"
    assert int(visits.max()) <= 1


def _plan_model(q, k, v, causal, window):
    """The TMA kernel's arithmetic over its tile plan, in torch on the CPU:
    q [B,Sq,H,D], k and v [B,Sk,KV,D] (bf16 values, fp32 math); the online
    softmax with scale*log2(e) folded into exp2, the mask only on edge
    tiles, P rounded to bf16 for P V; keys past Sk are zero rows, as TMA
    fills them."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    c = D ** -0.5 * 1.4426950408889634
    out = torch.zeros(B, Sq, H, D)
    for kvh in range(KV):
        for g, qa, qb, tiles in _tile_plan(Sq, Sk, G, D, causal, window):
            h = kvh * G + g
            if qb < qa:
                continue
            qr = q[:, qa:qb + 1, h].float()
            rows = torch.arange(qa, qb + 1)[:, None]
            m = torch.full((B, qb + 1 - qa), -1e30)
            l = torch.zeros(B, qb + 1 - qa)
            acc = torch.zeros(B, qb + 1 - qa, D)
            for k0, bk, edge in tiles:
                kt = torch.zeros(B, bk, D)
                vt = torch.zeros(B, bk, D)
                kt[:, :min(bk, Sk - k0)] = k[:, k0:k0 + bk, kvh].float()
                vt[:, :min(bk, Sk - k0)] = v[:, k0:k0 + bk, kvh].float()
                s = qr @ kt.transpose(1, 2)
                if edge:
                    keys = torch.arange(k0, k0 + bk)[None, :]
                    valid = keys < Sk
                    if causal:
                        valid = valid & (rows >= keys)
                    if window is not None:
                        valid = valid & (rows - keys < window)
                    s = torch.where(valid, s, -1e30)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2((m - m_new) * c)
                p = torch.exp2(s * c - (m_new * c)[..., None])
                if edge:
                    p = torch.where(valid, p, 0.0)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + p.bfloat16().float() @ vt
                m = m_new
            out[:, qa:qb + 1, h] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.bfloat16()


@pytest.mark.parametrize("case", PLAN_CASES)
def test_tile_plan_model_matches_reference(case):
    """The mirror's online softmax, with masks only on edge tiles and P in
    bf16, against the oracle within the bf16 bound of chip_smoke's
    checked_prefill_attention: 2e-2 + 2e-2 |want| + 2^-8 sum_j p_j |v_j|."""
    Sq, Sk, G, D, causal, window = PLAN_CASES[case]
    KV = 1 if G > 2 else 2
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(len(case), 1, Sq, Sk, G * KV, KV, D))
    got = _plan_model(q, k, v, causal, window).float()

    def oracle(vv):
        return tref.flash_attention_ref(
            q.transpose(1, 2).float(), k.transpose(1, 2).float(),
            vv.transpose(1, 2).float(), causal=causal,
            window=window).transpose(1, 2)

    want = oracle(v)
    spread = oracle(v.abs())
    tol = TOL["bfloat16"]
    excess = (got - want).abs() - tol - tol * want.abs() - 2 ** -8 * spread
    assert float(excess.max()) <= 0, float((got - want).abs().max())
    # a row with no visible key is 0, as in the oracle
    assert bool((got[:, ~_mask(Sq, Sk, causal, window).any(1)] == 0).all())


@pytest.mark.gpu
def test_cuda_main_path_shape_runs_the_tma_kernel():
    """At smollm-360m's prefill shape the profiler sees K2's device time in
    the TMA kernel alone (the route's kernel name)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v = (torch.from_numpy(a).bfloat16().cuda()
               for a in _inputs(5, 1, 2048, 2048, 15, 5, 64))
    tops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tops.flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "flash_fwd_" in e.key]
    assert names and all("flash_fwd_tma_wgmma" in n for n in names), names
