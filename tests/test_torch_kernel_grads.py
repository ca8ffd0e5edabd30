"""The autograd wiring of the port's kernels (``kernels/ops.py``): K2, K3,
K4 and K5's gated entry each go through an ``autograd.Function`` under
grad mode, whose forward runs the kernel's wrapper (on CPU tensors, its
plain twin) and saves only the inputs, and whose backward re-runs the
plain path the JAX model differentiates (``ops.PLAIN``).

The gradients are held to plain autograd of that same path, exactly (the
backward runs the same operations on the same inputs), and to autograd of
the kernel's oracle within the forward's tolerance. None of the
wrappers takes float64 (each kernel takes float32 and bfloat16), so the
cases run in those two."""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke
from repro_torch.kernels import decode_attention, flash_attention, moe_gmm, ops, ref
from repro_torch.kernels import rglru_scan, ssd_scan
from repro_torch.models.attention import _reference_attention
from repro_torch.models.base import init_tree, tree_leaves
from repro_torch.models.registry import build_model
from repro_torch.runtime.sharding import Sharder

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
MODES = {"causal": (True, None), "windowed": (True, 12), "bidir": (False, None)}


def _t(rng, shape, dtype, fn=None):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return (x if fn is None else fn(x)).to(dtype)


def _inputs(kernel, dtype, rng):
    """The float inputs of each entry, as leaves that require grad, and
    its keyword arguments."""
    if kernel == "flash_attention":
        B, S, H, KV, D = 2, 40, 6, 2, 16
        ins = [_t(rng, (B, S, H, D), dtype), _t(rng, (B, S, KV, D), dtype),
               _t(rng, (B, S, KV, D), dtype)]
    elif kernel == "moe_gmm":
        ins = [_t(rng, (4, 10, 16), dtype), _t(rng, (4, 16, 24), dtype, lambda w: w / 4)]
    elif kernel == "ssd_scan":
        B, S, H, P, N = 2, 32, 3, 8, 16
        ins = [_t(rng, (B, S, H, P), dtype),
               _t(rng, (B, S, H), torch.float32, torch.nn.functional.softplus),
               _t(rng, (H,), torch.float32, lambda a: -torch.exp(a / 2)),
               _t(rng, (B, S, N), dtype), _t(rng, (B, S, N), dtype)]
    else:
        B, S, W = 2, 37, 16
        ins = [_t(rng, (B, S, W), dtype, torch.sigmoid),
               _t(rng, (B, S, W), dtype, torch.sigmoid), _t(rng, (B, S, W), dtype),
               _t(rng, (W,), torch.float32, torch.nn.functional.logsigmoid),
               _t(rng, (B, W), torch.float32)]
    kw = {"ssd_scan": {"chunk": 8}}.get(kernel, {})
    return [x.requires_grad_(True) for x in ins], kw


#: each entry's oracle, for the tolerance check: the ref.py oracle, or for
#: K2 the model's materialised reference backend (ref.flash_attention_ref
#: masks its softmax in place, which autograd cannot differentiate)
ORACLES = {
    "flash_attention": lambda q, k, v, causal=True, window=None:
        _reference_attention(q, k, v, "causal" if causal else "bidir", window),
    "moe_gmm": ref.moe_gmm_ref,
    "ssd_scan": lambda x, dt, A, Bm, Cm, chunk: ref.ssd_ref(x, dt, A, Bm, Cm),
    "rglru_gated": ref.rglru_gated_ref,
}
KERNELS = list(ORACLES)


def _outs(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


def _weights(outs, rng, use):
    """Fixed upstream gradients: one random weight tensor for each output
    the loss takes (``use``: the indices of the outputs it takes)."""
    return {j: _t(rng, outs[j].shape, torch.float32) for j in use}


def _grads(fn, ins, kw, weights):
    outs = _outs(fn(*ins, **kw))
    loss = sum((outs[j].float() * w).sum() for j, w in weights.items())
    # the final state does not depend on C (K4): its gradient is None
    return outs, torch.autograd.grad(loss, ins, allow_unused=True)


def _cases():
    for kernel in KERNELS:
        for dtype in DTYPES:
            yield kernel, dtype, (0,)
    for kernel in ("ssd_scan", "rglru_gated"):  # the final state's gradient
        yield kernel, "float32", (1,)
        yield kernel, "float32", (0, 1)


@pytest.mark.parametrize("kernel,dtype,use", list(_cases()))
def test_function_gradients_equal_plain_autograd(kernel, dtype, use):
    """The Function's gradients are plain autograd's of ``ops.PLAIN``, bit
    for bit, and autograd's of the ref.py oracle within tolerance; a
    final state the loss does not take reaches the backward as None."""
    tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(7)
    ins, kw = _inputs(kernel, tdt, rng)
    if kernel == "flash_attention":
        kw = {"causal": True, "window": None}
    with torch.no_grad():
        weights = _weights(_outs(getattr(ops, kernel)(*ins, **kw)), rng, use)
    out, got = _grads(getattr(ops, kernel), ins, kw, weights)
    assert all(o.grad_fn is not None for o in out)
    _, want = _grads(ops.PLAIN[kernel], ins, kw, weights)
    assert [g is None for g in got] == [w is None for w in want]
    assert sum(g is not None for g in got) >= len(ins) - 1
    for g, w in zip(got, want):
        assert g is None or (g.dtype == w.dtype and torch.equal(g, w))
    _, oracle = _grads(ORACLES[kernel], ins, kw, weights)
    for g, w in zip(got, oracle):
        if g is not None:
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol * max(1.0, w.abs().max().item()))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chunk", [16, 1024])
def test_flash_attention_gradients_follow_mode_and_window(mode, chunk, monkeypatch):
    """K2's backward re-runs ``_chunked_attention`` with the call's mask,
    over several KV chunks or one."""
    causal, window = MODES[mode]
    monkeypatch.setattr(ops, "ATTN_CHUNK", chunk)
    rng = np.random.default_rng(3)
    ins, _ = _inputs("flash_attention", torch.float32, rng)
    kw = {"causal": causal, "window": window}
    with torch.no_grad():
        weights = _weights(_outs(ops.flash_attention(*ins, **kw)), rng, (0,))
    _, got = _grads(ops.flash_attention, ins, kw, weights)
    _, want = _grads(ORACLES["flash_attention"], ins, kw, weights)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5 * w.abs().max().item())


class _Packs:
    """Counts the tensors autograd saves (saved-tensor pack hooks)."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        def pack(t):
            self.n += 1
            return t

        self._hooks = torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)


@pytest.mark.parametrize("kernel", KERNELS)
def test_function_saves_only_its_inputs(kernel):
    ins, kw = _inputs(kernel, torch.float32, np.random.default_rng(0))
    with _Packs() as packs:
        getattr(ops, kernel)(*ins, **kw)
    assert packs.n == len(ins)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("how", ["inference_mode", "no_grad", "no input requires grad"])
def test_without_grad_the_wrapper_runs_as_it_is(kernel, how):
    """Under inference mode, no_grad or with no input requiring grad, the
    entry calls the kernel's wrapper directly: nothing saved, no grad_fn,
    the wrapper's output."""
    ins, kw = _inputs(kernel, torch.float32, np.random.default_rng(1))
    if how == "no input requires grad":
        ins = [x.detach() for x in ins]
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}.get(
        how, torch.enable_grad)
    with _Packs() as packs, ctx():
        got = _outs(getattr(ops, kernel)(*ins, **kw))
    assert packs.n == 0 and all(o.grad_fn is None for o in got)
    with torch.no_grad():
        want = _outs(ORACLES[kernel](*ins, **kw))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _wrapper_calls():
    rng = np.random.default_rng(2)
    q, k, v = _inputs("flash_attention", torch.float32, rng)[0]
    x, w = _inputs("moe_gmm", torch.float32, rng)[0]
    s = _inputs("ssd_scan", torch.float32, rng)[0]
    r = _inputs("rglru_gated", torch.float32, rng)[0]
    B, W, KV, D = 2, 8, 2, 16
    cache_pos = torch.arange(W, dtype=torch.int32).expand(B, W).contiguous()
    q_pos = torch.full((B,), W - 1, dtype=torch.int32)
    return {
        "flash_attention_fwd": lambda: flash_attention.flash_attention_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
        "moe_gmm": lambda: moe_gmm.moe_gmm(x, w),
        "ssd_scan": lambda: ssd_scan.ssd_scan(*s, chunk=8),
        "rglru_gated": lambda: rglru_scan.rglru_gated(*r),
        "rglru_gated log_a_base": lambda: rglru_scan.rglru_gated(
            *(t.detach() for t in r[:3]), r[3], r[4].detach()),
        "rglru_scan": lambda: rglru_scan.rglru_scan(
            r[0], r[1].detach(), r[4].detach()),
        "flash_decode": lambda: decode_attention.flash_decode(
            q[:, 0], k[:, :W].transpose(1, 2), v[:, :W].transpose(1, 2),
            cache_pos, q_pos),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_wrapper_raises_under_grad(name):
    """A kernel's output is written through a raw pointer, so a wrapper
    called outside its Function with an input that requires grad raises
    rather than hand back an output with no gradient; under no_grad it
    runs."""
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():
        call()


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_9b"])
def test_model_gradients_through_k2_equal_the_chunked_backends(arch):
    """The model with ``attn_backend="pallas"`` (K2's entry, here its CPU
    twin, under full remat) gives every param the chunked backend's
    gradient."""
    import dataclasses

    cfg = get_smoke(arch)
    model = build_model(cfg)
    params = init_tree(torch.Generator().manual_seed(0), model.param_specs(),
                       cfg.param_dtype, "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24), generator=gen,
                                     dtype=torch.int32),
             "positions": torch.arange(24, dtype=torch.int32).expand(2, 24)}
    grads = {}
    for backend in ("chunked", "pallas"):
        m = build_model(dataclasses.replace(cfg, attn_backend=backend))
        logits, _ = m.forward(params, batch, Sharder(None))
        grads[backend] = torch.autograd.grad(logits.square().mean(), leaves)
    for g, w in zip(grads["pallas"], grads["chunked"]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5 * w.abs().max().item())
