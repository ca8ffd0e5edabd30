"""The LM, dense and audio families: parameter and cache specs, the
full-sequence forward (prefill) and the decode step.

Port of ``repro/models/transformer.py``. Stacked ``[L, ...]`` parameters
and caches keep the JAX tree's keys; the layers run in a Python loop over
views of the stacks in place of ``lax.scan``, and the decode step writes
the cache in place. The audio family (hubert) is the dense block run
bidirectionally behind a frame-embedding frontend, with no decode. The
other families raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.base import tree_index, tree_map, torch_dtype

#: keys of RMSNorm scales, which the model reads in fp32 whatever the
#: compute dtype (layers.rmsnorm)
_NORM_KEYS = frozenset({"ln1", "ln2", "final_norm"})


def _stack_specs(specs: Any, n: int) -> Any:
    return tree_map(lambda s: s.stacked(n), specs)


def dense_block_specs(cfg) -> dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": attn.attn_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_act),
    }


def _res(sharder, x):
    return sharder.constrain(x, "act_batch", "act_seq", "act_embed")


def dense_block_fwd(p, cfg, sharder, x, positions, *, mode, window):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    h = sharder.sp_boundary(h)
    h = attn.attention_block(p["attn"], cfg, sharder, h, positions,
                             mode=mode, window=window)
    x = _res(sharder, x + h)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    h = sharder.sp_boundary(h)
    h = L.mlp(p["mlp"], h, cfg.mlp_act, sharder)
    return _res(sharder, x + h)


#: families whose layers are the dense block
_DENSE = ("dense", "audio")


def _unported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP M9)")


class LM:
    def __init__(self, cfg):
        self.cfg = cfg

    # ---------------- param specs ---------------- #
    def param_specs(self) -> dict:
        cfg = self.cfg
        if cfg.family not in _DENSE:
            raise _unported(cfg)
        specs: dict[str, Any] = {}
        if cfg.frontend == "token":
            specs["embed"] = L.embed_specs(cfg.vocab, cfg.d_model)
        else:
            d_in = cfg.frontend_dim or cfg.d_model
            specs["frontend"] = {"proj": L.frontend_proj_spec(d_in, cfg.d_model)}
        specs["final_norm"] = L.rmsnorm_spec(cfg.d_model)
        specs["unembed"] = L.unembed_spec(cfg.d_model, cfg.vocab)
        specs["layers"] = _stack_specs(dense_block_specs(cfg), cfg.n_layers)
        return specs

    def compute_params(self, params: dict) -> dict:
        """``params`` with every weight the model casts to the compute dtype
        cast once, ahead of time; RMSNorm scales stay as they are.

        The JAX model casts at each use (``w.astype(dt)``); casting here
        gives the same values without re-reading fp32 weights every step."""
        dt = torch_dtype(self.cfg.compute_dtype)

        def cast(tree: Any, key: str = "") -> Any:
            if isinstance(tree, dict):
                return {k: cast(v, k) for k, v in tree.items()}
            return tree if key in _NORM_KEYS else tree.to(dt)

        return cast(params)

    # ---------------- embedding in / out ---------------- #
    def _embed_in(self, params, batch, sharder):
        cfg = self.cfg
        cdt = torch_dtype(cfg.compute_dtype)
        if cfg.frontend == "token":
            x = L.embed(batch["tokens"], params["embed"]["tok"], cdt)
        else:
            x = L.frontend_proj(batch["embeds"].to(cdt),
                                params["frontend"]["proj"])
        return sharder.constrain(x, "act_batch", "act_seq", None)

    def _logits_out(self, params, x, sharder):
        cfg = self.cfg
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(x, params["unembed"])
        return sharder.constrain(logits, "act_batch", None, "act_vocab")

    # ---------------- full-sequence forward (prefill) ---------------- #
    def forward(self, params, batch, sharder) -> tuple[torch.Tensor, dict]:
        """batch {tokens [B,S] | embeds [B,S,Din], positions [B,S]}.
        Returns (logits [B,S,V], aux). The JAX forward wraps each block in
        ``cfg.remat``; rematerialisation only matters to a backward pass,
        so this forward-only port has none (``torch.utils.checkpoint``
        arrives with training, ROADMAP M10)."""
        cfg = self.cfg
        if cfg.family not in _DENSE:
            raise _unported(cfg)
        x = self._embed_in(params, batch, sharder)
        positions = batch["positions"]
        mode = "bidir" if cfg.encoder_only else "causal"
        for i in range(cfg.n_layers):
            x = dense_block_fwd(tree_index(params["layers"], i), cfg, sharder,
                                x, positions, mode=mode, window=cfg.swa_window)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"moe_aux": zero, "moe_z": zero.clone()}
        return self._logits_out(params, x, sharder), aux

    # ---------------- decode ---------------- #
    def cache_specs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode cache")
        if cfg.family != "dense":
            raise _unported(cfg)
        per = attn.cache_specs(cfg, batch, max_len, window=cfg.swa_window)
        return {"layers": _stack_specs(per, cfg.n_layers)}

    def decode_step(self, params, cache, tokens, positions, sharder):
        """One token for every row. tokens [B]; positions [B] int32.
        Returns (logits [B,V], cache), the cache updated in place."""
        cfg = self.cfg
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        if cfg.family != "dense":
            raise _unported(cfg)
        x = L.embed(tokens[:, None], params["embed"]["tok"],
                    torch_dtype(cfg.compute_dtype))
        for i in range(cfg.n_layers):
            x = self._attn_decode_block(
                tree_index(params["layers"], i),
                tree_index(cache["layers"], i), x, positions, sharder)
        return self._logits_out(params, x, sharder)[:, 0], cache

    def _attn_decode_block(self, p, c, x, positions, sharder):
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, _ = attn.attention_decode(p["attn"], cfg, sharder, h, c, positions,
                                     window=cfg.swa_window)
        x = x + h
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.mlp_act, sharder)
