"""K4 parity: the port's ssd_ref and ops.ssd_scan (the plain version on
the CPU), and the model's ssd_chunked, against the JAX Pallas kernel in
interpret mode and the JAX oracle, on the same numpy inputs; and, on a
CUDA card, the hand-written kernel against both plain versions.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.mamba2 import ssd_chunked

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

# tests/test_kernels.py's tolerances: the SSD scan 1e-4 in fp32; bf16 x, B
# and C (dt and A stay fp32, as in the model) 2e-2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

CASES = {
    # tests/test_kernels.py:112-152: (B, S, H, P, N), chunk
    "B1 S64 H2 P16 N8 Q16": (1, 64, 2, 16, 8, 16),
    "B1 S64 H2 P16 N8 Q32": (1, 64, 2, 16, 8, 32),
    "B2 S128 H4 P32 N16 Q16": (2, 128, 4, 32, 16, 16),
    "B2 S128 H4 P32 N16 Q32": (2, 128, 4, 32, 16, 32),
    # mamba2-2.7b smoke: d_inner 128 in heads of 16, state 16, chunk 16
    "mamba2 smoke B2 S48 H8 P16 N16 Q16": (2, 48, 8, 16, 16, 16),
    # a chunk that is not a multiple of the kernel's 32-step tile
    "Q20 B1 S60 H3 P8 N12": (1, 60, 3, 8, 12, 20),
}


def _inputs(seed, B, S, H, P, N):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _cast(arrays, lib, dtype):
    """x, B and C in ``dtype``; dt and A fp32."""
    x, dt, A, Bm, Cm = arrays
    if lib == "jax":
        import jax.numpy as jnp
        f, low = jnp.asarray, getattr(jnp, dtype)
        return f(x).astype(low), f(dt), f(A), f(Bm).astype(low), f(Cm).astype(low)
    low = getattr(torch, dtype)
    f = torch.from_numpy
    return f(x).to(low), f(dt), f(A), f(Bm).to(low), f(Cm).to(low)


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_ssd_scan_matches_jax(case, dtype):
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    *dims, Q = CASES[case]
    arrays = _inputs(len(case), *dims)
    jin, tin = _cast(arrays, "jax", dtype), _cast(arrays, "torch", dtype)
    want = {"kernel": jops.ssd_scan(*jin, chunk=Q, interpret=True),
            "oracle": jref.ssd_ref(*jin)}
    got = {"ops": tops.ssd_scan(*tin, chunk=Q), "ref": tref.ssd_ref(*tin),
           "chunked": ssd_chunked(*tin, Q)}
    tol = TOL[dtype]
    for name, (y, h) in got.items():
        assert y.dtype == tin[0].dtype and h.dtype == torch.float32, name
        for wy, wh in want.values():
            np.testing.assert_allclose(y.float().numpy(), np.asarray(wy, np.float32),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(h.numpy(), np.asarray(wh, np.float32),
                                       rtol=tol, atol=tol)


def test_chunked_scan_matches_the_recurrence_at_any_chunk():
    tin = _cast(_inputs(3, 2, 64, 3, 8, 4), "torch", "float32")
    y_ref, h_ref = tref.ssd_ref(*tin)
    for Q in (1, 8, 64, 1000):  # 1000 > S: one chunk of S
        y, h = ssd_chunked(*tin, Q)
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h, h_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["x_dtype", "mixed_dtype", "dt_dtype",
                                 "device", "shape", "heads", "chunk"])
def test_ssd_scan_rejects_what_the_kernel_cannot_take(bad):
    x, dt, A, Bm, Cm = _cast(_inputs(0, 1, 32, 2, 4, 4), "torch", "float32")
    chunk = 16
    if bad == "x_dtype":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif bad == "mixed_dtype":
        Bm = Bm.bfloat16()
    elif bad == "dt_dtype":
        dt = dt.bfloat16()
    elif bad == "device":
        Cm = Cm.to("meta")
    elif bad == "shape":
        Bm = Bm[:, :16]
    elif bad == "heads":
        A = A[:1]
    else:
        chunk = 12  # 32 % 12 != 0
    with pytest.raises((TypeError, ValueError)):
        tops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def test_plain_calls_do_not_count_as_launches():
    before = tssd.ssd_scan.launches
    tops.ssd_scan(*_cast(_inputs(0, 1, 16, 2, 4, 4), "torch", "float32"), chunk=8)
    assert tssd.ssd_scan.launches == before


GPU_CASES = {
    **CASES,
    # mamba2-2.7b at full width, one row: 80 heads of 64, state 128, chunk 256
    "mamba2-2.7b B1 S512 H80 P64 N128 Q256": (1, 512, 80, 64, 128, 256),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    *dims, Q = GPU_CASES[case]
    x, dt, A, Bm, Cm = (t.cuda() for t in _cast(_inputs(len(case), *dims),
                                                "torch", dtype))
    before = tssd.ssd_scan.launches
    y, h = tops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    torch.cuda.synchronize()
    assert tssd.ssd_scan.launches == before + 1
    # against both plain versions run in fp32 on the same inputs, elementwise:
    # 1e-4 |want| + 1e-4 of the output's scale for the sum order (at full
    # width the chunked decays exp(cum_i - cum_j) take cum from a sum of Q
    # terms, |cum| ~ 470 at Q = 256, the recurrence multiplies one decay a
    # step, and an output near 0 is a difference of terms of the output's
    # size); in bf16 also 2^-8 |want| + 2e-2, one rounding of y to bf16
    bf16 = dtype == "bfloat16"
    wide = (x.float(), dt, A, Bm.float(), Cm.float())
    for wy, wh in (tref.ssd_ref(*wide), ssd_chunked(*wide, Q)):
        scale = max(1.0, wy.abs().max().item())
        tol = (1e-4 + (2 ** -8 if bf16 else 0.0)) * wy.abs() + 1e-4 * scale
        tol = tol + (2e-2 if bf16 else 0.0)
        assert bool(((y.float() - wy).abs() <= tol).all()), (
            ((y.float() - wy).abs() / tol).max().item())
        torch.testing.assert_close(h, wh, rtol=1e-4,
                                   atol=1e-4 * max(1.0, wh.abs().max().item()))
