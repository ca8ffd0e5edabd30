"""The LM, dense, audio, MoE, SSM and hybrid families: parameter and cache
specs, the full-sequence forward (prefill) and the decode step.

Port of ``repro/models/transformer.py``. Stacked ``[L, ...]`` parameters
and caches keep the JAX tree's keys; the layers run in a Python loop over
views of the stacks in place of ``lax.scan``, and the decode step writes
the cache in place. The audio family (hubert) is the dense block run
bidirectionally behind a frame-embedding frontend, with no decode. The
MoE family (deepseek) replaces the dense FFN with ``moe.moe_block`` after
``first_k_dense`` dense layers; the SSM family (mamba2) is a stack of
``mamba2`` mixers; the hybrid family (recurrentgemma) is the Griffin
pattern, stacked superblocks of (rec, rec, local attention) and a tail of
recurrent blocks keyed "0", "1", .... The VLM family raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models.base import tree_index, tree_map, torch_dtype

#: keys of the leaves the model reads in fp32 whatever the compute dtype:
#: RMSNorm scales (layers.rmsnorm, the mixer's gated "norm" too), the MoE
#: router (routing runs in fp32), the mamba2 mixer's A_log, dt_bias and
#: D (fp32 in the decode step and in the decay terms), and the RG-LRU's
#: lam (its log-sigmoid decay runs in fp32)
_FP32_KEYS = frozenset({"ln1", "ln2", "ln", "final_norm", "norm", "router",
                        "A_log", "dt_bias", "D", "lam"})


def _stack_specs(specs: Any, n: int) -> Any:
    return tree_map(lambda s: s.stacked(n), specs)


def dense_block_specs(cfg) -> dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": attn.attn_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_act),
    }


def moe_block_specs(cfg) -> dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "attn": attn.attn_specs(cfg),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "moe": moe_mod.moe_specs(cfg),
    }


def ssm_block_specs(cfg) -> dict:
    return {"ln": L.rmsnorm_spec(cfg.d_model), "mixer": m2.mamba2_specs(cfg)}


def rec_block_specs(cfg) -> dict:
    return {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "rec": rg.rglru_specs(cfg),
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


def moe_block_fwd(p, cfg, sharder, x, positions, *, mode, window):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    h = sharder.sp_boundary(h)
    h = attn.attention_block(p["attn"], cfg, sharder, h, positions,
                             mode=mode, window=window)
    x = _res(sharder, x + h)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    h = sharder.sp_boundary(h)
    h, aux = moe_mod.moe_block(p["moe"], cfg, sharder, h)
    return _res(sharder, x + h), aux


def ssm_block_fwd(p, cfg, sharder, x):
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    h = m2.mamba2_block(p["mixer"], cfg, sharder, h)
    return _res(sharder, x + h)


def rec_block_fwd(p, cfg, sharder, x):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    h = rg.rglru_block(p["rec"], cfg, sharder, h)
    x = _res(sharder, x + h)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    h = L.mlp(p["mlp"], h, cfg.mlp_act, sharder)
    return _res(sharder, x + h)


#: families whose layers are the dense block
_DENSE = ("dense", "audio")
#: families this port runs
_PORTED = (*_DENSE, "moe", "ssm", "hybrid")


def _unported(cfg) -> NotImplementedError:
    return NotImplementedError(
        f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP M9)")


class LM:
    def __init__(self, cfg):
        self.cfg = cfg

    # ---------------- param specs ---------------- #
    def param_specs(self) -> dict:
        cfg = self.cfg
        if cfg.family not in _PORTED:
            raise _unported(cfg)
        specs: dict[str, Any] = {}
        if cfg.frontend == "token":
            specs["embed"] = L.embed_specs(cfg.vocab, cfg.d_model)
        else:
            d_in = cfg.frontend_dim or cfg.d_model
            specs["frontend"] = {"proj": L.frontend_proj_spec(d_in, cfg.d_model)}
        specs["final_norm"] = L.rmsnorm_spec(cfg.d_model)
        specs["unembed"] = L.unembed_spec(cfg.d_model, cfg.vocab)
        if cfg.family == "moe":
            k = cfg.first_k_dense
            if k:
                specs["dense_layers"] = _stack_specs(dense_block_specs(cfg), k)
            specs["layers"] = _stack_specs(moe_block_specs(cfg), cfg.n_layers - k)
        elif cfg.family == "ssm":
            specs["layers"] = _stack_specs(ssm_block_specs(cfg), cfg.n_layers)
        elif cfg.family == "hybrid":
            n_super, n_tail = self._hybrid_split()
            specs["superblocks"] = _stack_specs(
                {"rec1": rec_block_specs(cfg), "rec2": rec_block_specs(cfg),
                 "attn": dense_block_specs(cfg)}, n_super)
            specs["tail"] = {str(i): rec_block_specs(cfg) for i in range(n_tail)}
        else:
            specs["layers"] = _stack_specs(dense_block_specs(cfg), cfg.n_layers)
        return specs

    def _hybrid_split(self) -> tuple[int, int]:
        """(superblocks of (rec, rec, attn), trailing recurrent blocks)."""
        n_super = self.cfg.n_layers // 3
        return n_super, self.cfg.n_layers - 3 * n_super

    def compute_params(self, params: dict) -> dict:
        """``params`` with every weight the model casts to the compute dtype
        cast once, ahead of time; the leaves it reads in fp32
        (``_FP32_KEYS``) stay as they are.

        The JAX model casts at each use (``w.astype(dt)``); casting here
        gives the same values without re-reading fp32 weights every step."""
        dt = torch_dtype(self.cfg.compute_dtype)

        def cast(tree: Any, key: str = "") -> Any:
            if isinstance(tree, dict):
                return {k: cast(v, k) for k, v in tree.items()}
            return tree if key in _FP32_KEYS else tree.to(dt)

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
        if cfg.family not in _PORTED:
            raise _unported(cfg)
        x = self._embed_in(params, batch, sharder)
        positions = batch["positions"]
        mode = "bidir" if cfg.encoder_only else "causal"
        aux_a = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_z = aux_a.clone()
        if cfg.family == "moe":
            for i in range(cfg.first_k_dense):
                x = dense_block_fwd(tree_index(params["dense_layers"], i), cfg,
                                    sharder, x, positions, mode=mode, window=None)
            for i in range(cfg.n_layers - cfg.first_k_dense):
                x, a = moe_block_fwd(tree_index(params["layers"], i), cfg, sharder,
                                     x, positions, mode=mode, window=None)
                aux_a = aux_a + a["moe_aux"]
                aux_z = aux_z + a["moe_z"]
        elif cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x = ssm_block_fwd(tree_index(params["layers"], i), cfg, sharder, x)
        elif cfg.family == "hybrid":
            for i in range(self._hybrid_split()[0]):
                p = tree_index(params["superblocks"], i)
                x = rec_block_fwd(p["rec1"], cfg, sharder, x)
                x = rec_block_fwd(p["rec2"], cfg, sharder, x)
                x = dense_block_fwd(p["attn"], cfg, sharder, x, positions,
                                    mode="causal", window=cfg.local_window)
            for key in sorted(params["tail"], key=int):
                x = rec_block_fwd(params["tail"][key], cfg, sharder, x)
        else:
            for i in range(cfg.n_layers):
                x = dense_block_fwd(tree_index(params["layers"], i), cfg, sharder,
                                    x, positions, mode=mode, window=cfg.swa_window)
        aux = {"moe_aux": aux_a, "moe_z": aux_z}
        return self._logits_out(params, x, sharder), aux

    # ---------------- decode ---------------- #
    def cache_specs(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode cache")
        if cfg.family == "ssm":
            return {"layers": _stack_specs(m2.mamba2_cache_specs(cfg, batch),
                                           cfg.n_layers)}
        if cfg.family == "hybrid":
            n_super, n_tail = self._hybrid_split()
            per_attn = attn.cache_specs(cfg, batch, max_len, window=cfg.local_window)
            per_rec = rg.rglru_cache_specs(cfg, batch)
            return {
                "superblocks": _stack_specs(
                    {"rec1": per_rec, "rec2": per_rec, "attn": per_attn}, n_super),
                "tail": {str(i): per_rec for i in range(n_tail)},
            }
        if cfg.family == "moe":
            per = attn.cache_specs(cfg, batch, max_len, window=None)
            out = {"layers": _stack_specs(per, cfg.n_layers - cfg.first_k_dense)}
            if cfg.first_k_dense:
                out["dense_layers"] = _stack_specs(per, cfg.first_k_dense)
            return out
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
        if cfg.family not in _PORTED:
            raise _unported(cfg)
        x = L.embed(tokens[:, None], params["embed"]["tok"],
                    torch_dtype(cfg.compute_dtype))
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                p = tree_index(params["layers"], i)
                h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
                h, _ = m2.mamba2_decode(p["mixer"], cfg, sharder, h,
                                        tree_index(cache["layers"], i))
                x = x + h
        elif cfg.family == "hybrid":
            for i in range(self._hybrid_split()[0]):
                p = tree_index(params["superblocks"], i)
                c = tree_index(cache["superblocks"], i)
                x = self._rec_decode_block(p["rec1"], c["rec1"], x, sharder)
                x = self._rec_decode_block(p["rec2"], c["rec2"], x, sharder)
                x = self._attn_decode_block(p["attn"], c["attn"], x, positions,
                                            sharder, window=cfg.local_window)
            for key in sorted(params["tail"], key=int):
                x = self._rec_decode_block(params["tail"][key], cache["tail"][key],
                                           x, sharder)
        else:
            stacks = ["layers"]
            if cfg.family == "moe" and cfg.first_k_dense:
                stacks = ["dense_layers", "layers"]
            for name in stacks:
                for i in range(params[name]["ln1"].shape[0]):
                    x = self._attn_decode_block(
                        tree_index(params[name], i), tree_index(cache[name], i),
                        x, positions, sharder)
        return self._logits_out(params, x, sharder)[:, 0], cache

    def _attn_decode_block(self, p, c, x, positions, sharder, *, window=None):
        """``window`` None means the config's ``swa_window`` (JAX
        transformer.py:414-416); the hybrid passes its ``local_window``."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, _ = attn.attention_decode(
            p["attn"], cfg, sharder, h, c, positions,
            window=cfg.swa_window if window is None else window)
        x = x + h
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if "mlp" in p:
            return x + L.mlp(p["mlp"], h, cfg.mlp_act, sharder)
        # decode-time MoE: the whole batch is ONE routing group ([B,1,d] ->
        # [1,B,d]), so expert capacity is shared across the rows instead of
        # a per-row floor (the JAX model's choice, transformer.py:429-435)
        hh, _ = moe_mod.moe_block(p["moe"], cfg, sharder, h.transpose(0, 1))
        return x + hh.transpose(0, 1)

    def _rec_decode_block(self, p, c, x, sharder):
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        h, _ = rg.rglru_decode(p["rec"], cfg, sharder, h, c)
        x = x + h
        h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.mlp_act, sharder)
