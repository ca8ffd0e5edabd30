"""Port parity: repro_torch.models.layers against repro.models.layers on the
same numpy inputs (fp32 2e-5, bf16 2e-2, the tolerances of
tests/test_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(j, t, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 60)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.normal(size=(60,))).astype(np.float32)
    jx, tx = _pair(x, dtype)
    _close(JL.rmsnorm(jx, jnp.asarray(w), 1e-6),
           TL.rmsnorm(tx, torch.from_numpy(w), 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_unembed(dtype):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(256, 48)).astype(np.float32)
    tokens = rng.integers(0, 256, size=(3, 7)).astype(np.int32)
    jdt, tdt, _ = DTYPES[dtype]
    je = JL.embed(jnp.asarray(tokens), jnp.asarray(table), jdt)
    te = TL.embed(torch.from_numpy(tokens), torch.from_numpy(table), tdt)
    assert te.dtype == tdt
    _close(je, te, dtype)
    w = (rng.normal(size=(48, 256)) / np.sqrt(48)).astype(np.float32)
    _close(JL.unembed(je, jnp.asarray(w)), TL.unembed(te, torch.from_numpy(w)),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,theta", [(20, 1e4), (64, 1e4), (16, 1e6)])
def test_apply_rope(dtype, D, theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, D)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    _close(JL.apply_rope(jx, jnp.asarray(pos), theta),
           TL.apply_rope(tx, torch.from_numpy(pos), theta), dtype)


def test_mrope_waits_for_the_vlm_slice():
    with pytest.raises(NotImplementedError):
        TL.apply_rope(torch.zeros(1, 1, 1, 8), torch.zeros(3, 1, 1), 1e4,
                      (2, 1, 1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(dtype, act):
    rng = np.random.default_rng(3)
    d, ff = 40, 96
    specs = JL.mlp_specs(d, ff, act)
    params = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
              for k, s in specs.items()}
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jout = JL.mlp({k: jnp.asarray(v) for k, v in params.items()}, jx, act)
    tout = TL.mlp({k: torch.from_numpy(v) for k, v in params.items()}, tx, act)
    assert set(TL.mlp_specs(d, ff, act)) == set(specs)
    _close(jout, tout, dtype)


def test_rope_freqs():
    np.testing.assert_allclose(TL.rope_freqs(64, 1e4).numpy(),
                               np.asarray(JL.rope_freqs(64, 1e4)),
                               rtol=1e-6, atol=0)
