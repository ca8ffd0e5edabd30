"""K5 parity: the port's rglru_ref and ops.rglru (the plain version on the
CPU) against the JAX Pallas kernel in interpret mode and the JAX oracle, on
the same numpy inputs; the model's CPU scan against the recurrence; and,
on a CUDA card, the hand-written kernel against the plain version.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.models.rglru import associative_scan

# tests/test_kernels.py's tolerances: fp32 2e-5 (the same fp32 steps in
# another order of operations), bf16 a and b 2e-2 (one bf16 rounding of y)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

#: tests/test_kernels.py:160: (B, S, W), multiples of the TPU kernel's blocks
CASES = {"B1 S64 W128": (1, 64, 128), "B2 S128 W256": (2, 128, 256),
         "B1 S32 W128": (1, 32, 128)}
#: lengths and widths the TPU kernel does not take (it asserts W % 128 == 0
#: and S % blk_s == 0); the port masks them
RAGGED = {"B2 S37 W100": (2, 37, 100), "B1 S300 W129": (1, 300, 129),
          "B3 S1 W7": (3, 1, 7)}


def _inputs(seed, B, S, W):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, W))))).astype(np.float32)
    b = (rng.normal(size=(B, S, W)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0


def _torch(arrays, dtype):
    """a and b in ``dtype``; h0 fp32."""
    a, b, h0 = (torch.from_numpy(x) for x in arrays)
    low = getattr(torch, dtype)
    return a.to(low), b.to(low), h0


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_rglru_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    arrays = _inputs(len(case), *CASES[case])
    low = getattr(jnp, dtype)
    ja, jb = (jnp.asarray(x).astype(low) for x in arrays[:2])
    jh0 = jnp.asarray(arrays[2])
    want = {"kernel": jops.rglru(ja, jb, jh0, interpret=True),
            "oracle": jref.rglru_ref(ja, jb, jh0)}
    tin = _torch(arrays, dtype)
    got = {"ops": tops.rglru(*tin), "ref": tref.rglru_ref(*tin)}
    for name, (y, h) in got.items():
        assert y.dtype == tin[0].dtype and h.dtype == torch.float32, name
        for wy, wh in want.values():
            _close(y, wy, TOL[dtype])
            _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", RAGGED)
def test_plain_rglru_at_ragged_shapes_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref

    arrays = _inputs(len(case), *RAGGED[case])
    low = getattr(jnp, dtype)
    wy, wh = jref.rglru_ref(jnp.asarray(arrays[0]).astype(low),
                            jnp.asarray(arrays[1]).astype(low),
                            jnp.asarray(arrays[2]))
    y, h = tops.rglru(*_torch(arrays, dtype))
    assert y.shape == RAGGED[case]
    _close(y, wy, TOL[dtype])
    _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100, 257])
def test_model_scan_matches_the_recurrence_at_any_length(S):
    """The model's CPU algorithm (a log-depth doubling scan from h = 0)
    against the step recurrence."""
    a, b, _ = (torch.from_numpy(x) for x in _inputs(S, 2, S, 24))
    want, _ = tref.rglru_ref(a, b, torch.zeros(2, 24))
    torch.testing.assert_close(associative_scan(a, b), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "h0_dtype", "device",
                                 "shape", "h0_shape", "empty", "rank"])
def test_rglru_rejects_what_the_kernel_cannot_take(bad):
    a, b, h0 = _torch(_inputs(0, 2, 16, 8), "float32")
    if bad == "dtype":
        a, b = a.half(), b.half()
    elif bad == "mixed_dtype":
        b = b.bfloat16()
    elif bad == "h0_dtype":
        h0 = h0.bfloat16()
    elif bad == "device":
        b = b.to("meta")
    elif bad == "shape":
        b = b[:, :8]
    elif bad == "h0_shape":
        h0 = h0[:1]
    elif bad == "empty":
        a, b = a[:, :0], b[:, :0]
    else:
        a, b = a[0], b[0]
    with pytest.raises((TypeError, ValueError)):
        tops.rglru(a, b, h0)


def test_plain_calls_do_not_count_as_launches():
    before = trg.rglru_scan.launches
    tops.rglru(*_torch(_inputs(0, 1, 16, 8), "float32"))
    assert trg.rglru_scan.launches == before


GPU_CASES = {
    **CASES, **RAGGED,
    # recurrentgemma-9b's lru_width, one row
    "recurrentgemma-9b B1 S512 W4096": (1, 512, 4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = GPU_CASES[case]
    a, b, h0 = (t.cuda() for t in _torch(_inputs(len(case), *shape), dtype))
    # a and b as views of wider buffers: the kernel reads them through strides
    wide = torch.cat([a, b], dim=2)
    a, b = wide[..., :shape[2]], wide[..., shape[2]:]
    before = trg.rglru_scan.launches
    y, h = tops.rglru(a, b, h0)
    torch.cuda.synchronize()
    assert trg.rglru_scan.launches == before + 1
    wy, wh = tref.rglru_ref(a, b, h0)
    # the kernel fuses a h + b into one FMA, the plain version rounds twice:
    # 1e-4 in fp32; bf16 y carries one bf16 rounding on each side
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, wh, rtol=1e-4, atol=1e-4)
