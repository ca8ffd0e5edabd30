"""The LM, dense family: parameter and cache specs and the decode step.

Port of ``repro/models/transformer.py``. Stacked ``[L, ...]`` parameters
and caches keep the JAX tree's keys; the layers run in a Python loop over
views of the stacks in place of ``lax.scan``, and the decode step writes
the cache in place. The other families, and the full-sequence forward,
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Any

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


def _unported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP M9)")


class LM:
    def __init__(self, cfg):
        self.cfg = cfg

    # ---------------- param specs ---------------- #
    def param_specs(self) -> dict:
        cfg = self.cfg
        if cfg.family != "dense":
            raise _unported(cfg)
        return {
            "embed": L.embed_specs(cfg.vocab, cfg.d_model),
            "final_norm": L.rmsnorm_spec(cfg.d_model),
            "unembed": L.unembed_spec(cfg.d_model, cfg.vocab),
            "layers": _stack_specs(dense_block_specs(cfg), cfg.n_layers),
        }

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

    # ---------------- decode ---------------- #
    def cache_specs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        if cfg.family != "dense":
            raise _unported(cfg)
        per = attn.cache_specs(cfg, batch, max_len, window=cfg.swa_window)
        return {"layers": _stack_specs(per, cfg.n_layers)}

    def decode_step(self, params, cache, tokens, positions, sharder):
        """One token for every row. tokens [B]; positions [B] int32.
        Returns (logits [B,V], cache), the cache updated in place."""
        cfg = self.cfg
        if cfg.family != "dense":
            raise _unported(cfg)
        x = L.embed(tokens[:, None], params["embed"]["tok"],
                    torch_dtype(cfg.compute_dtype))
        for i in range(cfg.n_layers):
            x = self._attn_decode_block(
                tree_index(params["layers"], i),
                tree_index(cache["layers"], i), x, positions, sharder)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return L.unembed(x, params["unembed"])[:, 0], cache

    def _attn_decode_block(self, p, c, x, positions, sharder):
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, _ = attn.attention_decode(p["attn"], cfg, sharder, h, c, positions,
                                     window=cfg.swa_window)
        x = x + h
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.mlp_act, sharder)
