"""Port parity for training: ``lm_loss``, ``warmup_cosine``, AdamW and
Adafactor, ``make_train_step`` (every smoke config), microbatching, the
remat modes and ``make_eval_step``, against the JAX package on the same
numpy weights, batches, gradients and optimizer state.

Tolerances. Optimizer arithmetic on identical inputs: 1e-6 relative (the
same fp32 operations; ``pow`` and the reductions may differ in the last
bit). A train step: the forward and backward sum in another order in each
framework, so the loss and each leaf's gradient agree to 1e-4 of the
leaf's largest |g| (fp32, two layers). AdamW's first update is
lr·g/(|g| + eps), about lr·sign(g), so where |g| is within the gradient
tolerance of 0 the two may step in opposite directions: there the updated
params agree to 2·lr, elsewhere to 1e-5 relative + 1e-3·lr."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke as j_get_smoke
from repro.configs.base import list_archs
from repro.models.registry import build_model as j_build_model
from repro.optim import adafactor_init as j_adafactor_init
from repro.optim import adafactor_update as j_adafactor_update
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim.schedules import warmup_cosine as j_warmup_cosine
from repro.runtime.sharding import Sharder as JSharder
from repro.train.loss import lm_loss as j_lm_loss
from repro.train.step import _loss_fn as j_loss_fn
from repro.train.step import _split_microbatches as j_split_microbatches
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_eval_step as j_make_eval_step
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs.base import get_smoke as t_get_smoke
from repro_torch.data.pipeline import SyntheticLMDataset, to_tensors
from repro_torch.launch.inputs import conditioned
from repro_torch.models.base import (init_tree, params_from_numpy, tree_leaves,
                                     tree_map)
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, warmup_cosine)
from repro_torch.runtime.sharding import Sharder as TSharder
from repro_torch.train import (init_train_state, lm_loss, make_eval_step,
                               make_train_step)
from repro_torch.train.step import _loss_fn as t_loss_fn

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

LR = 1e-3
GRAD_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(cfg, seed=0):
    """Numpy weights for both packages: the port's init of the smoke
    model, wq, wk and wv at std 1/sqrt(d_model) (``conditioned``: the
    init's fan-in makes attention near-hard, so a last-bit difference
    would move a logit by O(1))."""
    params = init_tree(torch.Generator().manual_seed(seed),
                       t_build_model(cfg).param_specs(), cfg.param_dtype, "cpu")
    return tree_map(lambda t: t.numpy(), conditioned(cfg, params))


def _batch(cfg, B=2, S=32, seed=1):
    return SyntheticLMDataset(cfg, global_batch=B, seq_len=S, seed=seed).batch_at(0)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


# --------------------------------------------------------------------------- #
# loss and schedule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("ignore_id", [-1, 3])
def test_lm_loss_matches_jax(z_loss, ignore_id):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(2, 7, 11))).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)
    labels[0, :3] = ignore_id
    jl, jm = j_lm_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss,
                       ignore_id=ignore_id)
    tl, tm = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                     z_loss=z_loss, ignore_id=ignore_id)
    _close(tl, jl, 1e-6, 0)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        _close(tm[key], jm[key], 1e-6, 0)
    assert float(tm["tokens"]) == (labels != ignore_id).sum() < 14


@pytest.mark.parametrize("step", [0, 1, 4, 10, 11, 37, 99, 100, 150])
def test_warmup_cosine_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    want = j_warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = warmup_cosine(s, **kw)
        assert got.dtype == torch.float32
        _close(got, want, 1e-6, 0)


# --------------------------------------------------------------------------- #
# optimizers
# --------------------------------------------------------------------------- #
def _opt_params(rng):
    """A tree with a matrix, a vector, an [8,...] stack (Adafactor's
    chunked path), an unfactored [2,1,5] leaf and a bf16 matrix."""
    return {"w": rng.normal(size=(6, 5)), "b": rng.normal(size=(7,)),
            "stack": {"k": rng.normal(size=(8, 4, 3))},
            "thin": rng.normal(size=(2, 1, 5)),
            "half": rng.normal(size=(3, 4))}


def _opt_tensors(tree):
    out = tree_map(lambda v: torch.from_numpy(np.asarray(v, np.float32)), tree)
    out["half"] = out["half"].to(torch.bfloat16)
    return out


def _as_jax(tree):
    out = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree)
    out["half"] = out["half"].astype(jnp.bfloat16)
    return out


OPTIMIZERS = {
    "adamw": (j_adamw_init, j_adamw_update, adamw_init, adamw_update, {}),
    "adamw wd 0": (j_adamw_init, j_adamw_update, adamw_init, adamw_update,
                   {"weight_decay": 0.0}),
    "adafactor": (j_adafactor_init, j_adafactor_update, adafactor_init,
                  adafactor_update, {}),
    "adafactor wd, unchunked": (j_adafactor_init, j_adafactor_update,
                                adafactor_init, adafactor_update,
                                {"weight_decay": 0.1, "chunk_stacked": 0}),
}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_jax_for_three_steps(name):
    j_init, j_update, t_init, t_update, kw = OPTIMIZERS[name]
    rng = np.random.default_rng(5)
    raw = _opt_params(rng)
    jp, tp = _as_jax(raw), _opt_tensors(raw)
    js, ts = j_init(jp), t_init(tp)
    for step, lr in enumerate((1e-2, 3e-3, 5e-3)):
        g = jax.tree_util.tree_map(lambda v: rng.normal(size=v.shape) * 10 ** (step - 1),
                                   raw)
        jp, js = j_update(_as_jax(g), js, jp, lr=lr, **kw)
        tp2, ts2 = t_update(_opt_tensors(g), ts, tp, lr=lr, **kw)
        assert tp2 is tp and ts2 is ts  # updated in place
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(
            {"params": jp, "opt": js})[0], tree_leaves({"params": tp, "opt": ts})):
        tol = 2 ** -8 if got.dtype == torch.bfloat16 else 1e-6
        assert got.dtype == {"bfloat16": torch.bfloat16, "int32": torch.int32}.get(
            str(want.dtype), torch.float32), path
        _close(got.float(), np.asarray(want, np.float32), tol, tol * 1e-3)
    assert int(ts["count"]) == 3


# --------------------------------------------------------------------------- #
# the train step, JAX against the port
# --------------------------------------------------------------------------- #
def _jax_step_and_grads(jcfg, params, batch, **kw):
    """JAX's make_train_step state and metrics, and the gradients of its
    ``_loss_fn``. AdamW's first step leaves m = (1 - b1) g in fp32, so the
    gradient is read off the state (to 1e-7 relative); Adafactor keeps no
    first moment, and there the gradients are compiled with the step."""
    model, sharder = j_build_model(jcfg), JSharder(None)
    step = j_make_train_step(model, sharder, **kw)
    state = j_init_train_state(model, jax.tree_util.tree_map(jnp.asarray, params))
    if jcfg.optimizer == "adamw":
        new, metrics = _np(jax.jit(step)(state, batch))
        return new, metrics, jax.tree_util.tree_map(
            lambda m: m.astype(np.float64) / (1 - 0.9), new["opt"]["m"])

    def both(state, b):
        grads = jax.grad(lambda p: j_loss_fn(model, sharder, p, b)[0])(state["params"])
        return step(state, b), grads

    (new, metrics), grads = jax.jit(both)(state, batch)
    return _np(new), _np(metrics), _np(grads)


def _port_step_and_grads(tcfg, params, batch, **kw):
    model, sharder = t_build_model(tcfg), TSharder(None)
    tparams = params_from_numpy(params, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tbatch = to_tensors(batch, "cpu")
    grads = torch.autograd.grad(t_loss_fn(model, sharder, tparams, tbatch)[0], leaves)
    state, metrics = make_train_step(model, sharder, **kw)(
        init_train_state(model, tparams), tbatch)
    return state, metrics, grads


def _check_step(jnew, jmet, jgrads, state, metrics, grads, lr=LR):
    for key in ("loss", "ce_loss", "accuracy", "tokens", "grad_norm", "lr"):
        _close(metrics[key], jmet[key], GRAD_TOL, 0)
    if "moe_aux" in jmet:
        _close(metrics["moe_aux"], jmet["moe_aux"], GRAD_TOL, 0)
    jg_leaves = jax.tree_util.tree_leaves(jgrads)
    for g, want in zip(grads, jg_leaves):
        scale = float(np.abs(want).max())
        assert scale > 0
        _close(g.detach(), want, GRAD_TOL, GRAD_TOL * scale)
    for got, want, jg in zip(tree_leaves(state["params"]),
                             jax.tree_util.tree_leaves(jnew["params"]), jg_leaves):
        got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
        near0 = np.abs(jg) <= 2 * GRAD_TOL * np.abs(jg).max()
        assert np.all(np.abs(got - want)[near0] <= 2 * lr)
        _close(got[~near0], want[~near0], 1e-5, 1e-3 * lr)
    assert int(state["step"]) == int(jnew["step"]) == 1


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_matches_jax(arch):
    jcfg, tcfg = j_get_smoke(arch), t_get_smoke(arch)
    params, batch = _weights(tcfg), _batch(tcfg)
    kw = dict(peak_lr=LR, warmup=0, total_steps=10)
    _check_step(*_jax_step_and_grads(jcfg, params, batch, **kw),
                *_port_step_and_grads(tcfg, params, batch, **kw))


@pytest.mark.parametrize("arch,k", [("smollm_360m", 2), ("qwen2_vl_7b", 2)])
def test_microbatched_train_step_matches_jax(arch, k):
    """Microbatches accumulated in fp32: JAX against the port, [3,B,S]
    M-RoPE positions split along their batch axis."""
    jcfg, tcfg = j_get_smoke(arch), t_get_smoke(arch)
    params, batch = _weights(tcfg), _batch(tcfg, B=4)
    kw = dict(peak_lr=LR, warmup=0, total_steps=10, microbatches=k)
    _check_step(*_jax_step_and_grads(jcfg, params, batch, **kw),
                *_port_step_and_grads(tcfg, params, batch, **kw))


@pytest.mark.parametrize("arch,k", [("smollm_360m", 2), ("qwen2_vl_7b", 2),
                                    ("qwen2_vl_7b", 3)])
def test_microbatched_train_step_matches_single(arch, k):
    """The twin of tests/test_smoke_archs.py's: k microbatches against one,
    with its tolerances. At k = 3 the JAX split takes the three M-RoPE
    streams for microbatches (ROADMAP Queue 3, F4); the port's splits the
    rows."""
    cfg = t_get_smoke(arch)
    params, batch = _weights(cfg), _batch(cfg, B=6)
    runs = [_port_step_and_grads(cfg, params, batch, peak_lr=LR, warmup=0,
                                 total_steps=10, microbatches=m)[:2] for m in (1, k)]
    (s1, m1), (s2, m2) = runs
    _close(m2["loss"], m1["loss"], 1e-4, 1e-5)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        _close(b.detach(), a.detach(), 5e-3, 5e-5)
    if cfg.mrope_sections is not None and k == 3:
        split = j_split_microbatches({"positions": jnp.asarray(batch["positions"])}, 3)
        assert split["positions"].shape == (3, 1, 6, 32)  # the streams, not the rows


# --------------------------------------------------------------------------- #
# remat and eval
# --------------------------------------------------------------------------- #
REMAT = {"full": ("full", False), "dots": ("dots", False),
         "full + remat_attention": ("full", True),
         "none + remat_attention": ("none", True)}


@pytest.mark.parametrize("arch", ["smollm_360m", "deepseek_moe_16b", "mamba2_2_7b",
                                  "recurrentgemma_9b"])
@pytest.mark.parametrize("remat", REMAT)
def test_remat_modes_give_nones_gradients(arch, remat):
    mode, remat_attention = REMAT[remat]
    base = t_get_smoke(arch)
    params = params_from_numpy(_weights(base), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = to_tensors(_batch(base), "cpu")
    grads = {}
    for name, cfg in (("none", dataclasses.replace(base, remat="none")),
                      (remat, dataclasses.replace(base, remat=mode,
                                                  remat_attention=remat_attention))):
        loss, _ = t_loss_fn(t_build_model(cfg), TSharder(None), params, batch)
        grads[name] = torch.autograd.grad(loss, leaves)
    for g, want in zip(grads[remat], grads["none"]):
        torch.testing.assert_close(g, want, rtol=1e-6,
                                   atol=1e-6 * want.abs().max().item())


def test_remat_recomputes_the_matmuls_only_under_full():
    """In the backward, "full" runs each block's matrix products again;
    "dots" keeps their outputs, so it runs as many as "none"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Matmuls(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    base = t_get_smoke("smollm_360m")
    params = params_from_numpy(_weights(base), device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = to_tensors(_batch(base), "cpu")
    counts = {}
    for mode in ("none", "full", "dots"):
        model = t_build_model(dataclasses.replace(base, remat=mode))
        loss, _ = t_loss_fn(model, TSharder(None), params, batch)
        with Matmuls() as m:
            torch.autograd.grad(loss, leaves)
        counts[mode] = m.n
    assert counts["dots"] == counts["none"] < counts["full"], counts


def test_unknown_remat_mode_raises():
    cfg = dataclasses.replace(t_get_smoke("smollm_360m"), remat="some")
    params = params_from_numpy(_weights(t_get_smoke("smollm_360m")), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with pytest.raises(ValueError, match="unknown remat mode"):
        t_loss_fn(t_build_model(cfg), TSharder(None), params,
                  to_tensors(_batch(cfg), "cpu"))


@pytest.mark.parametrize("arch", ["smollm_360m", "deepseek_moe_16b", "hubert_xlarge"])
def test_eval_step_matches_jax(arch):
    jcfg, tcfg = j_get_smoke(arch), t_get_smoke(arch)
    params, batch = _weights(tcfg), _batch(tcfg)
    want = jax.jit(j_make_eval_step(j_build_model(jcfg), JSharder(None)))(
        jax.tree_util.tree_map(jnp.asarray, params), batch)
    got = make_eval_step(t_build_model(tcfg), TSharder(None))(
        params_from_numpy(params, device="cpu"), to_tensors(batch, "cpu"))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], GRAD_TOL, 0)
