"""Train and eval steps (microbatch gradient accumulation, the remat of the
model's forward, the optimizer), and the inference steps: the
full-sequence forward (prefill) and the function the engine calls once per
decode token. Port of ``repro/train/step.py``.

The train step is eager: the model's forward and ``torch.autograd.grad``
of the loss, a microbatch at a time, with the gradients summed in fp32
buffers (``accum_dtype``; not ``.grad``, which would sum a bf16 tree in
bf16), then the optimizer's in-place update. Under a ``Sharder`` with a
mesh the params and batch are DTensors: each op runs on the local shards,
the microbatches split each rank's rows, and the gradients are reduced to
their params' placements once, after the last microbatch. On the card the forward runs
the hand-written kernels and their backward the plain paths the JAX model
differentiates (``kernels/ops.py``).

Nothing in here checkpoints: the preemption point is the step's call site,
which the trainer and the serving engine wrap with
``repro_torch.core.autockpt`` (docs/PREEMPTION.md tier 3).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.base import torch_dtype, tree_leaves, tree_unflatten
from repro_torch.optim import make_optimizer
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime.sharding import is_dtensor
from repro_torch.train.loss import lm_loss


def init_train_state(model, params) -> dict:
    """{"step": 0-d int32, "params": params, "opt": the optimizer's state},
    on the params' device (the JAX state's tree, key for key)."""
    opt = make_optimizer(model.cfg.optimizer)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"step": step, "params": params, "opt": opt.init(params)}


def _loss_fn(model, sharder, params, batch):
    logits, aux = model.forward(params, batch, sharder)
    loss, metrics = lm_loss(logits, batch["labels"], z_loss=model.cfg.z_loss)
    if model.cfg.family == "moe":
        loss = loss + aux["moe_aux"] + aux["moe_z"]
        metrics["moe_aux"] = aux["moe_aux"]
    metrics["loss"] = loss
    return loss, metrics


def _chunks(x: torch.Tensor, k: int, axis: int) -> list:
    """``x`` as ``k`` pieces along ``axis``. A DTensor sharded on ``axis``
    is split in each rank's own rows (microbatch j is every rank's j-th
    block, as a data-parallel rank splits its batch), so no rows move
    between ranks."""
    if is_dtensor(x) and any(getattr(p, "dim", None) == axis
                             for p in x.placements):
        from torch.distributed.tensor import DTensor

        shape = list(x.shape)
        shape[axis] //= k
        stride = torch.empty(shape, device="meta").stride()
        return [DTensor.from_local(piece, x.device_mesh, x.placements,
                                   run_check=False, shape=torch.Size(shape),
                                   stride=stride)
                for piece in torch.chunk(x.to_local(), k, dim=axis)]
    return list(torch.chunk(x, k, dim=axis))


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    """``batch`` as ``k`` microbatches of its rows (views). Every input
    splits along its first dim, but M-RoPE's [3,B,S] positions, which
    split along their second. The JAX split picks the axis by divisibility
    (step.py:46-55), so at k = 3 it splits the three position streams
    instead (ROADMAP Queue 3, F4); here the axis follows the input. A
    batch-sharded DTensor splits each rank's rows (``_chunks``)."""

    def axis(key, x):
        return 1 if key == "positions" and x.ndim == 3 else 0

    for key, x in batch.items():
        rows = (x.to_local() if is_dtensor(x) else x).shape[axis(key, x)] \
            if x.ndim else 0
        if x.ndim == 0 or rows % k:
            raise ValueError(f"cannot split {key} {tuple(x.shape)} into {k} "
                             f"microbatches")
    parts = {key: _chunks(x, k, axis(key, x)) for key, x in batch.items()}
    return [{key: p[j] for key, p in parts.items()} for j in range(k)]


def _reduced(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements: a data-parallel rank's
    partial sum all-reduced (or reduce-scattered onto a sharded leaf).
    A plain tensor is returned as it is."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(
    model,
    sharder,
    *,
    microbatches: int = 1,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    accum_dtype: str = "float32",
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients (summed over ``microbatches`` in ``accum_dtype``, then
    averaged), one optimizer update of ``state``'s params and moments in
    place, and metrics (tensors on the device: the loss terms, ``grad_norm``
    and ``lr``). A param that the loss does not reach raises: its gradient
    would be missing, not zero."""
    opt = make_optimizer(model.cfg.optimizer)
    adt = torch_dtype(accum_dtype)

    def grads_of(params, leaves, batch):
        loss, metrics = _loss_fn(model, sharder, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        with sharder.scope():
            return _train_step(state, batch)

    def _train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if microbatches == 1:
            grads, metrics = grads_of(params, leaves, batch)
        else:
            grads, mlist = None, []
            for mb in _split_microbatches(batch, microbatches):
                g, m = grads_of(params, leaves, mb)
                if grads is None:  # the first microbatch's, in accum_dtype
                    grads = [gi.to(adt, copy=True) for gi in g]
                else:
                    for acc, gi in zip(grads, g):
                        acc.add_(gi.to(adt))
                mlist.append(m)
                del g
            for acc in grads:
                acc.div_(microbatches)
            metrics = {k: torch.stack([m[k] for m in mlist]).mean(0)
                       for k in mlist[0]}
        # data parallelism: sum the ranks' gradients once, after the
        # microbatches (a no-op for plain tensors)
        grads = [_reduced(g, p) for g, p in zip(grads, leaves)]

        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        params, opt_state = opt.update(tree_unflatten(params, grads),
                                       state["opt"], params, lr)
        metrics["grad_norm"] = torch.sqrt(
            sum(torch.sum(torch.square(g.float())) for g in grads))
        metrics["lr"] = lr
        return ({"step": state["step"] + 1, "params": params, "opt": opt_state},
                metrics)

    return train_step


def make_eval_step(model, sharder) -> Callable[[dict, dict], dict]:
    @torch.no_grad()
    def eval_step(params: dict, batch: dict) -> dict:
        with sharder.scope():
            _, metrics = _loss_fn(model, sharder, params, batch)
        return metrics

    return eval_step


def _no_grad(sharder):
    """Inference mode; under a mesh, no_grad: a DTensor's view of a tensor
    made outside inference mode (its params, its cache) cannot take a
    version counter inside it."""
    return torch.inference_mode() if sharder.mesh is None else torch.no_grad()


def make_prefill_step(model, sharder) -> Callable[[dict, dict], torch.Tensor]:
    """Full-sequence forward (inference prefill): logits only."""

    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        with _no_grad(sharder), sharder.scope():
            logits, _ = model.forward(params, batch, sharder)
        return logits

    return prefill_step


def make_serve_step(model, sharder) -> Callable[..., tuple[torch.Tensor, dict]]:
    """One decode token against a KV cache, updated in place."""

    def serve_step(params: dict, cache: dict, tokens: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        with _no_grad(sharder), sharder.scope():
            return model.decode_step(params, cache, tokens, positions, sharder)

    return serve_step
