"""Model-layout entry points to the kernels, and the gradients of K2–K5.

The model keeps activations as ``[B,S,H,D]`` and caches as ``[B,W,KV,D]``;
the attention kernels take ``[B,H,S,D]`` and ``[B,KV,W,D]``. Where the JAX
adapters copy with ``swapaxes``, these pass transposed views: the CUDA
kernels read them through their strides (and K2 writes its output in model
layout). K3, K4 and K5 take the model's layouts as they are (the
expert-major dispatch buffer; ``[B,S,H,P]`` for the SSD scan, which the JAX
kernel wrapper moves to ``[B,H,S,P]`` with copies; ``[B,S,W]`` for the
RG-LRU scan).

Gradients. The kernels are forward kernels, and a kernel writes its output
through a raw pointer that autograd cannot see, so each wrapper raises when
an input requires grad under grad mode (``build.forbid_grad``). Where grad
mode is on and an input requires grad, ``flash_attention``, ``moe_gmm``,
``ssd_scan`` and ``rglru_gated`` go through an ``autograd.Function``: its
forward launches the kernel as the no-grad path does and saves only the
inputs (a flash kernel's recompute backward); its backward re-runs, under
``enable_grad``, the plain path that the JAX model differentiates
(``PLAIN``) and returns autograd's gradient of it. The JAX package has no
backward kernel, so neither has the port. Under ``inference_mode``, or with
no input requiring grad, the kernel's wrapper is called directly: nothing
is saved and nothing more is launched.

DTensors. The kernels launch on raw pointers, so they take plain tensors.
Each entry here gives a kernel DTensor inputs through ``_on_shards``: where
every mesh dimension shards the inputs along dims that keep the call local
(the batch, or the heads, experts or channels the kernel treats
independently) or replicates them all, the kernel runs on each rank's
shards (``local_map``) and its outputs are DTensors of the matching
placements; any other placement (a split sequence, head dim or
contraction, a partial sum) would need communication inside the kernel,
and raises.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ssd

#: the KV chunk of K2's plain backward (``_chunked_attention``): the
#: configs' ``attn_chunk``; the chunk moves only the rounding
ATTN_CHUNK = 1024


# --------------------------------------------------------------------------- #
# the plain paths the JAX model differentiates (the backward re-runs them)
# --------------------------------------------------------------------------- #
# (imported where called: the models import this module)
def plain_flash_attention(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """The JAX model's chunked streaming softmax (its default backend)."""
    from repro_torch.models.attention import _chunked_attention

    return _chunked_attention(q, k, v, "causal" if causal else "bidir",
                              window, ATTN_CHUNK)


def plain_ssd_scan(x, dt, A, Bm, Cm, chunk: int = 256):
    """The JAX model's chunked SSD algebra."""
    from repro_torch.models.mamba2 import ssd_chunked

    return ssd_chunked(x, dt, A, Bm, Cm, chunk)


def plain_rglru_gated(r, i, x, log_a_base, h0):
    """The gate math of ``ref.rglru_gated_ref``, then the JAX model's
    log-depth doubling scan with h0 folded into the first step (the
    step-by-step recurrence would make a graph S nodes deep)."""
    from repro_torch.models.rglru import associative_scan

    a, b = ref.rglru_decay_input(r, i, x, log_a_base)
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = associative_scan(a, b)
    return h.to(x.dtype), h[:, -1]


#: each kernel's plain path, by the name of its entry here
PLAIN: dict[str, Callable] = {
    "flash_attention": plain_flash_attention,
    "moe_gmm": ref.moe_gmm_ref,
    "ssd_scan": plain_ssd_scan,
    "rglru_gated": plain_rglru_gated,
}


def _plain_grads(ctx, plain: Callable, grad_outputs) -> tuple:
    """autograd's gradient of ``plain`` at the saved inputs, for the inputs
    that need one (None for the others), against the outputs whose
    incoming gradient is not None."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outputs = plain(*inputs)
    if isinstance(outputs, torch.Tensor):
        outputs = (outputs,)
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if g is not None]
    wanted = [t for t in inputs if t.requires_grad]
    if not pairs or not wanted:
        return (None,) * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                   [g for _, g in pairs], allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in inputs)


# --------------------------------------------------------------------------- #
# DTensor inputs: the kernel on each rank's shards
# --------------------------------------------------------------------------- #
def _on_shards(name: str, fn: Callable, args: tuple, layouts: dict,
               plain: Optional[Callable] = None):
    """``fn(*args)`` on each rank's shards where the placements make the
    call local. ``layouts`` maps a kind ("batch", "heads", ...) to (the
    dim each arg is split along, None for an arg that must be replicated;
    the dim each output is split along). Elsewhere a CPU mesh runs
    ``plain`` (the kernel's plain version) on the DTensors, which insert
    the communication; a CUDA mesh raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.runtime.sharding import is_dtensor

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    n_out = len(next(iter(layouts.values()))[1])
    outs = [[] for _ in range(n_out)]
    # a replicated arg of a call split along the others sees a slice of
    # them: its local gradient is a partial sum over that mesh dim
    grads = [[] for _ in args]
    for i in range(mesh.ndim):
        got = [a.placements[i] if is_dtensor(a) else None for a in args]
        if all(p is None or isinstance(p, Replicate) for p in got):
            for o in outs + grads:
                o.append(Replicate())
            continue
        for in_dims, out_dims in layouts.values():
            if all((d is None and (p is None or isinstance(p, Replicate))) or
                   (d is not None and isinstance(p, Shard)
                    and p.dim % args[j].ndim == d)
                   for j, (p, d) in enumerate(zip(got, in_dims))):
                for o, d in zip(outs, out_dims):
                    o.append(Shard(d))
                for g, p, d in zip(grads, got, in_dims):
                    g.append(Partial() if d is None else p)
                break
        else:
            if plain is not None and mesh.device_type == "cpu":
                return plain(*args)
            raise ValueError(
                f"{name}: placements {got} on mesh dim {mesh.mesh_dim_names[i]} "
                f"would need communication inside the kernel (local only "
                f"when split along {sorted(layouts)})")
    # local_map reads a list as one output's placements, a tuple as one
    # entry an output
    out_pl = outs[0] if n_out == 1 else tuple(outs)
    in_pl = tuple(a.placements if is_dtensor(a) else None for a in args)
    in_grad = tuple(tuple(g) if is_dtensor(a) else None
                    for a, g in zip(args, grads))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=in_grad, device_mesh=mesh)(*args)


def attention_on_shards(fn: Callable, q, k, v):
    """``fn(q, k, v)`` (attention in model layout: q [B,S,H,D], k, v
    [B,T,KV,D]) on each rank's shards, where some are DTensors.

    Per mesh dim the plan follows q: split along the batch, k and v are
    split along it too; along the heads, k and v are split along theirs
    where the KV heads divide, else kept whole and each rank takes the KV
    heads of its query heads (GQA with fewer KV heads than ranks); where q
    is whole, k and v are made whole. q split along its sequence or head
    dim is gathered first (attention needs every key for a query). k and v
    are moved to the plan (the gathers GSPMD would insert), and a whole
    k, v's gradient is each rank's partial sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.runtime.sharding import is_dtensor

    mesh = next(a.device_mesh for a in (q, k, v) if is_dtensor(a))
    q, k, v = (a if is_dtensor(a) else
               DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
               for a in (q, k, v))
    H, KV = q.shape[2], k.shape[2]
    qp, kvp, kv_grad = [], [], []
    head_dims = []  # mesh dims splitting q's heads, major first
    for i in range(mesh.ndim):
        p = q.placements[i]
        d = p.dim % 4 if isinstance(p, Shard) else None
        if d == 0:
            qp.append(Shard(0))
            kvp.append(Shard(0))
            kv_grad.append(Shard(0))
        elif d == 2:
            qp.append(Shard(2))
            head_dims.append(i)
            kvp.append(None)  # decided below, once every split is known
            kv_grad.append(None)
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
            kv_grad.append(Replicate())
    n_head = math.prod(mesh.size(i) for i in head_dims)
    gqa_local = bool(head_dims) and KV % n_head != 0
    for i in head_dims:
        kvp[i] = Replicate() if gqa_local else Shard(2)
        kv_grad[i] = Partial() if gqa_local else Shard(2)
    if tuple(q.placements) != tuple(qp):
        q = q.redistribute(mesh, qp)
    k = k if tuple(k.placements) == tuple(kvp) else k.redistribute(mesh, kvp)
    v = v if tuple(v.placements) == tuple(kvp) else v.redistribute(mesh, kvp)
    local_fn = fn
    if gqa_local:
        h_l, G = H // n_head, H // KV
        if not (G % h_l == 0 or h_l % G == 0):
            raise ValueError(f"attention: {h_l} query heads a rank do not "
                             f"tile groups of {G}")
        coord = mesh.get_coordinate()
        shard = 0
        for i in head_dims:
            shard = shard * mesh.size(i) + coord[i]
        first = shard * h_l // G
        n_kv = max(1, h_l // G)

        def local_fn(q, k, v):
            return fn(q, k[:, :, first:first + n_kv], v[:, :, first:first + n_kv])

    return local_map(local_fn, out_placements=list(qp),
                     in_placements=(tuple(qp), tuple(kvp), tuple(kvp)),
                     in_grad_placements=(tuple(qp), tuple(kv_grad), tuple(kv_grad)),
                     device_mesh=mesh)(q, k, v)


def _whole(x, dim: int):
    """A DTensor made whole along ``dim`` (its other splits kept): the
    decode query's heads, when the ring's split has taken their mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.ndim == dim else p
          for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def _dt(*args) -> bool:
    from repro_torch.runtime.sharding import is_dtensor

    return any(is_dtensor(a) for a in args)


# --------------------------------------------------------------------------- #
# K2
# --------------------------------------------------------------------------- #
def _flash(q, k, v, causal, window):
    o = _fa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
    return o.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        plain = lambda q, k, v: plain_flash_attention(
            q, k, v, causal=ctx.causal, window=ctx.window)
        return (*_plain_grads(ctx, plain, (g,)), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q [B,S,H,D]; k, v [B,T,KV,D] (model layout) -> [B,S,H,D]."""
    if _dt(q, k, v):
        return attention_on_shards(
            lambda q, k, v: flash_attention(q, k, v, causal=causal, window=window),
            q, k, v)
    if build.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash(q, k, v, causal, window)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_pos: torch.Tensor, q_pos: torch.Tensor, *,
                 window: Optional[int] = None) -> torch.Tensor:
    """q [B,H,D]; caches [B,W,KV,D] (model layout) -> [B,H,D]."""
    if _dt(q, k_cache, v_cache, cache_pos, q_pos):
        return _on_shards(
            "flash_decode",
            lambda *t: flash_decode(*t, window=window),
            (q, k_cache, v_cache, cache_pos, q_pos),
            {"batch": ((0, 0, 0, 0, 0), (0,)),
             "heads": ((1, 2, 2, None, None), (1,))},
            plain=lambda q, k, v, cp, qp: ref.flash_decode_ref(
                _whole(q, 1), k.transpose(1, 2), v.transpose(1, 2), cp, qp,
                window=window))
    return _dec.flash_decode(q, k_cache.transpose(1, 2),
                             v_cache.transpose(1, 2), cache_pos, q_pos,
                             window=window)


# --------------------------------------------------------------------------- #
# K3
# --------------------------------------------------------------------------- #
class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gmm.moe_gmm(x, w)

    @staticmethod
    def backward(ctx, g):
        return _plain_grads(ctx, ref.moe_gmm_ref, (g,))


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,D] (any row strides); w [E,D,F] -> [E,C,F] in x's dtype."""
    if _dt(x, w):
        return _on_shards("moe_gmm", moe_gmm, (x, w),
                          {"experts": ((0, 0), (0,))})
    if build.needs_grad(x, w):
        return _MoeGmm.apply(x, w)
    return _gmm.moe_gmm(x, w)


# --------------------------------------------------------------------------- #
# K4
# --------------------------------------------------------------------------- #
class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # the final state's is often None
        return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        plain = lambda *t: plain_ssd_scan(*t, chunk=ctx.chunk)
        return (*_plain_grads(ctx, plain, (gy, gh)), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 256):
    """x [B,S,H,P]; dt [B,S,H]; A [H]; Bm, Cm [B,S,N] (model layout) ->
    (y [B,S,H,P], final state [B,H,P,N] fp32)."""
    if _dt(x, dt, A, Bm, Cm):
        return _on_shards(
            "ssd_scan", lambda *t: ssd_scan(*t, chunk=chunk), (x, dt, A, Bm, Cm),
            {"batch": ((0, 0, None, 0, 0), (0, 0)),
             "heads": ((2, 2, 0, None, None), (2, 1))})
    if build.needs_grad(x, dt, A, Bm, Cm):
        return _SsdScan.apply(x, dt, A, Bm, Cm, chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


# --------------------------------------------------------------------------- #
# K5
# --------------------------------------------------------------------------- #
def rglru(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a, b [B,S,W]; h0 [B,W] fp32 (model layout) -> (y [B,S,W] in a's
    dtype, final state [B,W] fp32). No model path takes it (and so it has
    no gradient): the model takes the gated entry."""
    return _rg.rglru_scan(a, b, h0)


class _RglruGated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, i, x, log_a_base, h0):
        ctx.save_for_backward(r, i, x, log_a_base, h0)
        ctx.set_materialize_grads(False)  # the final state's is often None
        return _rg.rglru_gated(r, i, x, log_a_base, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        return _plain_grads(ctx, plain_rglru_gated, (gy, gh))


def rglru_gated(r: torch.Tensor, i: torch.Tensor, x: torch.Tensor,
                log_a_base: torch.Tensor, h0: torch.Tensor):
    """K5's gated entry, the one the model takes on the card: r, i, x
    [B,S,W] (the gates' sigmoids and the block's input, one dtype);
    log_a_base [W] fp32; h0 [B,W] fp32 -> (y [B,S,W] in x's dtype, final
    state [B,W] fp32). The decay and gated input never reach device
    memory."""
    if _dt(r, i, x, log_a_base, h0):
        return _on_shards(
            "rglru_gated", rglru_gated, (r, i, x, log_a_base, h0),
            {"batch": ((0, 0, 0, None, 0), (0, 0)),
             "channels": ((2, 2, 2, 0, 1), (2, 1))})
    if build.needs_grad(r, i, x, log_a_base, h0):
        return _RglruGated.apply(r, i, x, log_a_base, h0)
    return _rg.rglru_gated(r, i, x, log_a_base, h0)
