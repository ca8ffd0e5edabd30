"""K2 parity: the port's flash_attention_ref and ops.flash_attention (the
plain version on the CPU) against the JAX Pallas kernel in interpret mode
and the JAX oracle, on the same numpy inputs; and, on a CUDA card, the
hand-written kernel against the plain version.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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
