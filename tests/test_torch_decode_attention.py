"""K1 parity: the port's flash_decode (plain version on the CPU) against the
JAX Pallas kernel in interpret mode and the JAX oracle, on the same numpy
inputs; and, on a CUDA card, the hand-written kernel against the plain
version.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, B, H, KV, W, D, q_pos, masked_rows=()):
    """Model-layout caches [B,W,KV,D]; slot w holds the newest position
    p <= q_pos[b] with p % W == w (-1 if none), so q_pos >= W wraps."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, W, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, W, KV, D)).astype(np.float32)
    qp = np.asarray(q_pos, np.int32)
    p = qp[:, None].astype(np.int64) - np.mod(qp[:, None] - np.arange(W), W)
    cpos = np.where(p >= 0, p, -1).astype(np.int32)
    cpos[list(masked_rows)] = -1
    return q, k, v, cpos, qp


CASES = {
    # name: (B, H, KV, W, D, q_pos, window, masked rows)
    "test_kernels-a g1": (1, 4, 4, 64, 32, [37], None, ()),
    "test_kernels-a g2 w48": (1, 4, 2, 64, 32, [60], 48, ()),
    "test_kernels-b g2 w48": (2, 8, 4, 128, 16, [5, 60], 48, ()),
    "test_kernels-b g1": (2, 8, 8, 128, 16, [20, 127], None, ()),
    "smollm smoke heads": (2, 3, 1, 32, 20, [10, 31], None, ()),
    "smollm full heads": (2, 15, 5, 96, 64, [0, 95], None, ()),
    "ring wrap window 48": (3, 15, 5, 48, 64, [47, 100, 1000], 48, ()),
    "fully masked row": (2, 3, 1, 40, 20, [5, 30], None, (0,)),
    # recurrentgemma-9b's local attention heads (MQA, G=16, D=256) on a
    # ring that wraps, with its window
    "recurrentgemma D256 G16 ring window 64": (2, 16, 1, 64, 256, [63, 200], 64, ()),
}


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_flash_decode_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    B, H, KV, W, D, q_pos, window, masked = CASES[case]
    q, k, v, cpos, qp = _inputs(len(case), B, H, KV, W, D, q_pos, masked)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    want_kernel = jops.flash_decode(jq, jk, jv, jnp.asarray(cpos), jnp.asarray(qp),
                                    window=window, interpret=True)
    want_ref = jref.flash_decode_ref(jq, jnp.swapaxes(jk, 1, 2),
                                     jnp.swapaxes(jv, 1, 2), jnp.asarray(cpos),
                                     jnp.asarray(qp), window=window)
    got = tops.flash_decode(tq, tk, tv, torch.from_numpy(cpos),
                            torch.from_numpy(qp), window=window)
    assert got.dtype == tdt and got.shape == (B, H, D)
    tol = TOL[dtype]
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
    for b in masked:
        assert bool((got[b] == 0).all())


def test_kernel_layout_entry_matches_model_layout():
    q, k, v, cpos, qp = _inputs(0, 2, 6, 2, 50, 16, [49, 20])
    t = [torch.from_numpy(a) for a in (q, k, v, cpos, qp)]
    model = tops.flash_decode(*t, window=32)
    kernel = tdec.flash_decode(t[0], t[1].transpose(1, 2).contiguous(),
                               t[2].transpose(1, 2).contiguous(), t[3], t[4],
                               window=32)
    torch.testing.assert_close(model, kernel, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "pos_dtype", "shape", "group",
                                 "window"])
def test_flash_decode_rejects_what_the_kernel_cannot_take(bad):
    q, k, v, cpos, qp = (torch.from_numpy(a) for a in
                         _inputs(0, 1, 4, 2, 16, 8, [5]))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "pos_dtype":
        cpos = cpos.long()
    elif bad == "shape":
        cpos = cpos[:, :8]
    elif bad == "group":
        q = torch.zeros(1, 3, 8)
    else:
        kw["window"] = -1
    with pytest.raises((TypeError, ValueError)):
        tops.flash_decode(q, k, v, cpos, qp, **kw)


def test_plain_calls_do_not_count_as_launches():
    before = tdec.flash_decode.launches
    t = [torch.from_numpy(a) for a in _inputs(0, 1, 3, 1, 8, 20, [3])]
    tops.flash_decode(*t)
    assert tdec.flash_decode.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, KV, W, D, q_pos, window, masked = CASES[case]
    q, k, v, cpos, qp = _inputs(len(case), B, H, KV, W, D, q_pos, masked)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt).cuda() for a in (q, k, v)]
    t += [torch.from_numpy(cpos).cuda(), torch.from_numpy(qp).cuda()]
    before = tdec.flash_decode.launches
    got = tops.flash_decode(*t, window=window)
    torch.cuda.synchronize()
    assert tdec.flash_decode.launches == before + 1
    want = tref.flash_decode_ref(t[0], t[1].transpose(1, 2), t[2].transpose(1, 2),
                                 t[3], t[4], window=window)
    # the card sums in another order than the plain version: 1e-4 in fp32
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
