"""The reference's first training steps: the plain model's loss and
gradients a row at a time (the token mean over the batch is the mean of
the rows' means, as the program's equal microbatches give it), then the
plain AdamW update, from the same initial weights and the same batches as
the program's trainer."""

from __future__ import annotations

import torch

from usfbench.reference.dense import (AdamW, DenseLM, Quant, exact_fp32, flat, nest,
                                      warmup_cosine)


def first_steps(conf: dict, params: dict, batches: list[dict], *, peak_lr: float,
                warmup: int, total: int, device, quant: Quant = None,
                rows=None) -> dict:
    """``params``: the initial weight tree (any float dtype; copied to
    float32 here). ``batches``: one {"tokens", "labels"} of numpy arrays a
    step. ``rows`` keeps only those rows of each batch (a planted fault).

    Returns each step's loss, each leaf's first gradient and its norm, and
    each leaf's change after the steps (``delta``, norms)."""
    model = DenseLM(conf)
    p = {k: v.detach().to(device=device, dtype=torch.float32, copy=True)
         for k, v in flat(params).items()}
    p0 = {k: v.clone() for k, v in p.items()}
    opt = AdamW()
    losses, grad_norms = [], None
    with exact_fp32():
        for i, b in enumerate(batches):
            tok = torch.as_tensor(b["tokens"], device=device)
            lab = torch.as_tensor(b["labels"], device=device)
            keep = list(range(tok.shape[0])) if rows is None else list(rows)
            for v in p.values():
                v.requires_grad_(True)
            tree = nest(p)
            g = {k: torch.zeros_like(v) for k, v in p.items()}
            total_loss = 0.0
            for r in keep:
                loss = model.loss(tree, tok[r:r + 1], lab[r:r + 1], quant)
                parts = torch.autograd.grad(loss / len(keep), list(p.values()))
                for k, gi in zip(p, parts):
                    g[k] += gi
                total_loss += float(loss.detach()) / len(keep)
            for v in p.values():
                v.requires_grad_(False)
            losses.append(total_loss)
            if i == 0:
                grad_norms = {k: float(v.double().norm()) for k, v in g.items()}
            opt.update(p, g, warmup_cosine(i, peak_lr=peak_lr, warmup=warmup,
                                           total=total))
    delta = {k: float((p[k].double() - p0[k].double()).norm()) for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": delta}

