"""K3 parity: the port's moe_gmm_ref and ops.moe_gmm (the plain version on
the CPU) against the JAX Pallas kernel in interpret mode and the JAX
oracle, on the same numpy inputs; and, on a CUDA card, the hand-written
kernel against the plain version.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# tests/test_kernels.py's tolerances: fp32 2e-5, bf16 2e-2 (one bf16
# rounding of outputs of magnitude ~1)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

CASES = {
    # tests/test_kernels.py:180-193, E x C x D x F
    "2x64x32x48": (2, 64, 32, 48),
    "4x100x64x96": (4, 100, 64, 96),
    "1x128x128x128": (1, 128, 128, 128),
    # deepseek-moe-16b smoke, B=2 rows of C=6: wg/wu and wd
    "deepseek smoke wg": (8, 12, 64, 32),
    "deepseek smoke wd": (8, 12, 32, 64),
    # nothing a multiple of a tile or of 8
    "ragged 3x5x37x19": (3, 5, 37, 19),
}


def _inputs(seed, E, C, D, F):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(E, C, D)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) * 0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_moe_gmm_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    x, w = _inputs(len(case), *CASES[case])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    want_kernel = jops.moe_gmm(jx, jw, interpret=True)
    want_ref = jref.moe_gmm_ref(jx, jw)
    got = tops.moe_gmm(tx, tw)
    assert got.dtype == tdt and got.shape == want_ref.shape
    tol = TOL[dtype]
    for t in (got, tref.moe_gmm_ref(tx, tw)):
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)


def test_strided_dispatch_view_matches_contiguous():
    # the model's dispatch buffer [E, B, C, d] viewed as [E, B*C, d], and a
    # row-strided view of it: the same products as contiguous copies
    x, w = _inputs(0, 4, 12, 16, 8)
    buf = torch.from_numpy(x).reshape(4, 2, 6, 16)
    for view in (buf.reshape(4, 12, 16), buf.reshape(4, 12, 16)[:, ::2]):
        got = tops.moe_gmm(view, torch.from_numpy(w))
        torch.testing.assert_close(got, tref.moe_gmm_ref(view.contiguous(),
                                                         torch.from_numpy(w)),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "device", "rank",
                                 "experts", "depth", "empty"])
def test_moe_gmm_rejects_what_the_kernel_cannot_take(bad):
    x, w = (torch.from_numpy(a) for a in _inputs(0, 2, 4, 8, 6))
    if bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "mixed_dtype":
        w = w.bfloat16()
    elif bad == "device":
        w = w.to("meta")
    elif bad == "rank":
        x = x[0]
    elif bad == "experts":
        w = w[:1]
    elif bad == "depth":
        w = w[:, :5]
    else:
        x = x[:, :0]
    with pytest.raises((TypeError, ValueError)):
        tops.moe_gmm(x, w)


def test_plain_calls_do_not_count_as_launches():
    before = tgmm.moe_gmm.launches
    tops.moe_gmm(*(torch.from_numpy(a) for a in _inputs(0, 2, 4, 8, 6)))
    assert tgmm.moe_gmm.launches == before


GPU_CASES = {
    **CASES,
    # deepseek-moe-16b full width: decode (B=4 as one group, C=4) and prefill
    # (B=4 rows of C=241), wg and wd
    "deepseek decode wg": (64, 4, 2048, 1408),
    "deepseek decode wd": (64, 4, 1408, 2048),
    "deepseek prefill wg": (64, 964, 2048, 1408),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(tdt).cuda()
            for a in _inputs(len(case), *GPU_CASES[case]))
    before = tgmm.moe_gmm.launches
    got = tops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert tgmm.moe_gmm.launches == before + 1
    want = tref.moe_gmm_ref(x, w).float()
    # the card sums in another order than the plain version: 1e-4 in fp32;
    # in bf16 one rounding of the output, 2e-2 plus 2e-2 relative
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
