"""Port parity for the full-sequence forward (prefill): multihead_attention
(all three backends), attention_block, LM.forward and make_prefill_step
against the JAX package on the same numpy inputs and weights, for the
dense family (smollm-360m, h2o-danube with its window) and the audio
family (hubert-xlarge, bidirectional); and prefill logits against
teacher-forced decode logits on one set of weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import get_smoke as j_get_smoke
from repro.models import attention as jattn
from repro.models.base import init_tree as j_init_tree
from repro.models.registry import build_model as j_build_model
from repro.runtime.sharding import Sharder as JSharder
from repro.train.step import make_prefill_step as j_make_prefill_step
from repro_torch.configs.base import get_arch as t_get_arch
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.launch.inputs import make_batch, make_decode_inputs
from repro_torch.models import attention as tattn
from repro_torch.models.base import init_tree, params_from_numpy, tree_leaves
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.train.step import make_prefill_step, make_serve_step

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MODES = {"causal": ("causal", None), "windowed": ("causal", 12),
         "bidir": ("bidir", None)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    """Within ``tol`` of the output's scale: the projections sum terms of
    that size in another order in each framework."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", ["reference", "chunked", "pallas"])
def test_multihead_attention_matches_jax(backend, mode, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    m, window = MODES[mode]
    rng = np.random.default_rng(3)
    B, S, H, KV, D = 2, 40, 6, 2, 16   # S % chunk != 0: chunked pads T
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    kw = dict(mode=m, window=window, backend=backend, chunk=16)
    want = jattn.multihead_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), **kw)
    got = tattn.multihead_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == (B, S, H, D)
    _close(got, want, tol)


def test_multihead_attention_rejects_an_unknown_backend():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="backend"):
        tattn.multihead_attention(x, x, x, backend="splash")


#: smoke configs of the families this slice ports, as (JAX, port) pairs
ARCHS = ["smollm_360m", "qwen1_5_110b", "h2o_danube_3_4b", "hubert_xlarge"]


def _configs(arch, **kw):
    return (dataclasses.replace(j_get_smoke(arch), **kw),
            dataclasses.replace(t_get_smoke(arch), **kw))


def _randomize_biases(attn, rng):
    """Zero-initialised qkv biases would not exercise the bias path."""
    for k in ("bq", "bk", "bv"):
        if k in attn:
            attn[k] = rng.normal(scale=0.5, size=attn[k].shape).astype(np.float32)
    return attn


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    rng = np.random.default_rng(7)
    params = _randomize_biases(
        _np_tree(j_init_tree(jax.random.PRNGKey(0), jattn.attn_specs(jcfg))), rng)
    B, S = 2, 40
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    mode = "bidir" if jcfg.encoder_only else "causal"
    want = jattn.attention_block(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg, JSharder(None),
        jnp.asarray(x), jnp.asarray(pos), mode=mode, window=jcfg.swa_window)
    got = tattn.attention_block(
        params_from_numpy(params, device="cpu"), tcfg, TSharder(None),
        torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(pos)),
        mode=mode, window=tcfg.swa_window)
    _close(got, want, 2e-5)


def _weights(jcfg, seed=0):
    """The JAX init of the model as numpy arrays, qkv biases randomised,
    and wq, wk, wv rescaled to std 1/sqrt(d_model).

    The init takes the fan-in of wq [d,H,hd] and wk, wv [d,KV,hd] as H and
    KV (ROADMAP Queue 3), which makes the attention a near-hard argmax that
    turns a last-bit difference between the frameworks into a visible logit
    change; with the d_model fan-in the scores are O(1), as in a trained
    model, and the comparison holds at the stated tolerances."""
    params = _np_tree(j_init_tree(jax.random.PRNGKey(seed),
                                  j_build_model(jcfg).param_specs(),
                                  jcfg.param_dtype))
    attn = _randomize_biases(params["layers"]["attn"], np.random.default_rng(seed))
    for key, n in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads),
                   ("wv", jcfg.n_kv_heads)):
        attn[key] = attn[key] * np.float32(np.sqrt(n / jcfg.d_model))
    return params


def _batch(cfg, B, S, seed):
    """The same numpy batch for both packages."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "token":
        x = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    else:
        x = {"embeds": rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)}
    x["positions"] = np.ascontiguousarray(
        np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ["smollm_360m", "h2o_danube_3_4b",
                                  "hubert_xlarge"])
def test_prefill_logits_match_jax(arch, backend, dtype):
    # S = 40 > danube-smoke's swa_window 16: the window cuts
    jcfg, tcfg = _configs(arch, attn_backend=backend, compute_dtype=dtype)
    params = _weights(jcfg)
    batch = _batch(jcfg, 2, 40, seed=1)
    want = j_make_prefill_step(j_build_model(jcfg), JSharder(None))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = t_build_model(tcfg)
    got = make_prefill_step(tmodel, TSharder(None))(
        tmodel.compute_params(params_from_numpy(params, device="cpu")),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 40, jcfg.vocab)
    _close(got, want, DTYPES[dtype][2])
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))


def test_forward_returns_logits_and_zero_aux():
    cfg = t_get_smoke("smollm_360m")
    model = t_build_model(cfg)
    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       device="cpu")
    batch = make_batch(cfg, 2, 8, torch.Generator().manual_seed(1), "cpu",
                       with_labels=False)
    logits, aux = model.forward(params, batch, TSharder(None))
    torch.testing.assert_close(
        logits, make_prefill_step(model, TSharder(None))(params, batch))
    assert sorted(aux) == ["moe_aux", "moe_z"]
    assert all(float(a) == 0.0 for a in aux.values())


@pytest.mark.parametrize("backend", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", ["smollm_360m", "qwen1_5_110b",
                                  "h2o_danube_3_4b"])
def test_prefill_agrees_with_teacher_forced_decode(arch, backend):
    """Logits of one forward at every position t equal the decode step's
    after feeding tokens 0..t; danube's ring (W = 16) wraps at S = 24."""
    cfg = dataclasses.replace(t_get_smoke(arch), attn_backend=backend)
    model = t_build_model(cfg)
    params = model.compute_params(params_from_numpy(
        _weights(j_get_smoke(arch)), device="cpu"))
    B, S = 2, 24
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, B, S, seed=2).items()}
    prefill = make_prefill_step(model, TSharder(None))(params, batch)
    step = make_serve_step(model, TSharder(None))
    cache, _, _ = make_decode_inputs(cfg, B, S, torch.Generator(), "cpu")
    for t in range(S):
        logits, cache = step(params, cache, batch["tokens"][:, t],
                             torch.full((B,), t, dtype=torch.int32))
        want = prefill[:, t]
        torch.testing.assert_close(
            logits, want, rtol=2e-5, atol=2e-5 * max(1.0, want.abs().max().item()))


def test_audio_param_specs_match_jax():
    jcfg, tcfg = j_get_smoke("hubert_xlarge"), t_get_smoke("hubert_xlarge")
    jspecs = j_build_model(jcfg).param_specs()
    tspecs = t_build_model(tcfg).param_specs()
    assert "embed" not in tspecs and tspecs["frontend"]["proj"].shape == (
        jcfg.frontend_dim, jcfg.d_model)
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda s: hasattr(s, "axes"))[0]
    tflat = tree_leaves(tspecs)
    assert [(s.shape, s.axes, s.init) for _, s in jflat] == [
        (s.shape, s.axes, s.init) for s in tflat]
    for name in ("hubert_xlarge", "h2o_danube_3_4b"):
        assert (t_get_arch(name).param_count_analytic()
                == j_get_arch(name).param_count_analytic())


def test_compute_params_casts_the_audio_tree_but_not_norms():
    cfg = dataclasses.replace(t_get_smoke("hubert_xlarge"),
                              compute_dtype="bfloat16")
    model = t_build_model(cfg)
    cp = model.compute_params(init_tree(torch.Generator().manual_seed(0),
                                        model.param_specs(), device="cpu"))
    assert cp["frontend"]["proj"].dtype == torch.bfloat16
    for key in ("w1", "b1", "w2", "b2"):
        assert cp["layers"]["mlp"][key].dtype == torch.bfloat16
    assert cp["layers"]["ln1"].dtype == torch.float32
    assert cp["final_norm"].dtype == torch.float32


def test_encoder_only_model_has_no_decode():
    cfg = t_get_smoke("hubert_xlarge")
    model = t_build_model(cfg)
    with pytest.raises(ValueError, match="encoder-only"):
        model.cache_specs(2, 8)
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step({}, {}, torch.zeros(2, 1, cfg.frontend_dim),
                          torch.zeros(2, dtype=torch.int32), TSharder(None))


@pytest.mark.parametrize("arch", ["smollm_360m", "hubert_xlarge"])
def test_make_batch_layout(arch):
    cfg = t_get_smoke(arch)
    batch = make_batch(cfg, 3, 10, torch.Generator().manual_seed(0), "cpu")
    if cfg.frontend == "token":
        assert batch["tokens"].shape == (3, 10)
        assert batch["tokens"].dtype == torch.int32
        assert int(batch["tokens"].max()) < cfg.vocab
    else:
        assert "tokens" not in batch
        assert batch["embeds"].shape == (3, 10, cfg.frontend_dim)
        assert batch["embeds"].dtype == getattr(torch, cfg.compute_dtype)
    assert batch["positions"].dtype == torch.int32
    assert bool((batch["positions"] == torch.arange(10)).all())
    assert batch["labels"].shape == (3, 10)
    assert "labels" not in make_batch(cfg, 1, 4, torch.Generator(), "cpu",
                                      with_labels=False)


def test_weights_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    specs = t_build_model(t_get_smoke("smollm_360m")).param_specs()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_tree(torch.Generator(), specs)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    assert params_from_numpy({"w": np.zeros(3, np.float32)},
                             device="cpu")["w"].device.type == "cpu"
