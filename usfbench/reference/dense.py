"""The plain reference of a dense decoder LM (SmolLM, Llama's layout), in
float32 PyTorch with no kernels, no cache and no batching tricks.

It reads a weight tree in the serving and training checkpoint layout
(``embed.tok [V, d]``, ``layers.attn.wq [L, d, H, hd]``, ...; each stack's
first axis is the layer) and follows the published architecture: RMSNorm
before attention and before the SwiGLU MLP, rotary embeddings on split
halves, grouped-query attention with a causal mask, a final RMSNorm and an
untied output matrix. Departures from the source are in the configuration
file's ``reduced`` list (``tie_word_embeddings``).

``quant``, where given, rounds every tensor the program holds in its
compute type (the residual stream, each norm's output, the projections,
attention's output, the MLP's hidden, the logits) and both operands of
every matrix product: the control runs this same model in float8 where
the configuration states bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def exact_fp32():
    """Float32 products in float32: TF32 off for the block."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` with one scale for the tensor (its
    largest magnitude onto ``top``), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Float8 training's rounding: values in e4m3, gradients in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float8 (e4m3; its gradient in e5m2), back in float32."""
    return _Fp8.apply(x)


def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    return x if quant is None else quant(x)


def _mm(a: torch.Tensor, b: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is not None:
        a, b = quant(a), quant(b)
    return a @ b


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, D] at positions 0..S-1; the halves of D rotate as pairs."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class DenseLM:
    """The model of a configuration file's keys (Hugging Face names)."""

    def __init__(self, conf: dict):
        self.d = conf["hidden_size"]
        self.H = conf["num_attention_heads"]
        self.KV = conf["num_key_value_heads"]
        self.hd = conf.get("head_dim") or self.d // self.H
        self.eps = conf["rms_norm_eps"]
        self.theta = float(conf["rope_theta"])
        self.L = conf["num_hidden_layers"]

    def layer(self, p: dict, i: int, x: torch.Tensor, quant: Quant) -> torch.Tensor:
        B, S, d = x.shape
        H, KV, hd = self.H, self.KV, self.hd
        a = p["attn"]
        h = _q(rmsnorm(x, p["ln1"][i].float(), self.eps), quant)
        q = _q(_mm(h, a["wq"][i].float().reshape(d, H * hd), quant), quant).view(B, S, H, hd)
        k = _q(_mm(h, a["wk"][i].float().reshape(d, KV * hd), quant), quant).view(B, S, KV, hd)
        v = _q(_mm(h, a["wv"][i].float().reshape(d, KV * hd), quant), quant).view(B, S, KV, hd)
        q, k = _q(rope(q, self.theta), quant), _q(rope(k, self.theta), quant)
        # query head h reads key/value head h // (H / KV)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # [B, H, S, hd]
        s = _mm(q * hd ** -0.5, k.transpose(-1, -2), quant)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        prob = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = _q(_mm(prob, v, quant), quant).transpose(1, 2).reshape(B, S, H * hd)
        x = _q(x + _q(_mm(o, a["wo"][i].float().reshape(H * hd, d), quant), quant), quant)
        m = p["mlp"]
        h = _q(rmsnorm(x, p["ln2"][i].float(), self.eps), quant)
        g = _q(_mm(h, m["gate"][i].float(), quant), quant)
        u = _q(_mm(h, m["up"][i].float(), quant), quant)
        hid = _q(F.silu(g) * u, quant)
        return _q(x + _q(_mm(hid, m["down"][i].float(), quant), quant), quant)

    def logits(self, params: dict, tokens: torch.Tensor, quant: Quant = None,
               checkpoint_layers: bool = False) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] in float32."""
        x = _q(params["embed"]["tok"].float()[tokens.long()], quant)
        for i in range(self.L):
            if checkpoint_layers and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    self.layer, params["layers"], i, x, quant, use_reentrant=False)
            else:
                x = self.layer(params["layers"], i, x, quant)
        x = _q(rmsnorm(x, params["final_norm"].float(), self.eps), quant)
        return _q(_mm(x, params["unembed"].float(), quant), quant)

    def loss(self, params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             quant: Quant = None) -> torch.Tensor:
        """Token-mean cross entropy of the next tokens."""
        lg = self.logits(params, tokens, quant, checkpoint_layers=True)
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1).long())


# --------------------------------------------------------------------------- #
# the optimizer the training configuration states: AdamW with a linear
# warm-up and a cosine to a tenth of the peak
# --------------------------------------------------------------------------- #
def warmup_cosine(step: int, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> float:
    if step < warmup:
        return peak_lr * step / max(warmup, 1)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


class AdamW:
    def __init__(self, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.count = 0
        self.m: dict = {}
        self.v: dict = {}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, lr: float) -> None:
        """``params`` and ``grads``: flat {name: tensor}; updated in place."""
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g.square())
            p.sub_(lr * ((m / bc1) / ((v / bc2).sqrt() + self.eps) + self.wd * p))


def flat(tree: dict, prefix: str = "") -> dict:
    """{"a.b.c": leaf} of a nested dict."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, name + "."))
        else:
            out[name] = v
    return out


def nest(flat_tree: dict) -> dict:
    out: dict = {}
    for name, v in flat_tree.items():
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out
