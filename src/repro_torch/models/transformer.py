"""The LM, dense, audio, VLM, MoE, SSM and hybrid families: parameter and
cache specs, the full-sequence forward (training, with the JAX model's
remat policies, and prefill) and the decode step.

Port of ``repro/models/transformer.py``. Stacked ``[L, ...]`` parameters
and caches keep the JAX tree's keys; the layers run in a Python loop over
views of the stacks in place of ``lax.scan``, and the decode step writes
the cache in place. The audio family (hubert) is the dense block run
bidirectionally behind a frame-embedding frontend, with no decode; the
VLM family (qwen2-vl) is the dense block behind a patch-embedding
frontend, with M-RoPE over [3,B,S] position streams (and [B,1,Din]
embeddings with [3,B] positions in the decode step). The MoE family (deepseek) replaces the dense FFN with ``moe.moe_block`` after
``first_k_dense`` dense layers; the SSM family (mamba2) is a stack of
``mamba2`` mixers; the hybrid family (recurrentgemma) is the Griffin
pattern, stacked superblocks of (rec, rec, local attention) and a tail of
recurrent blocks keyed "0", "1", ....
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
from repro_torch.models.base import (tree_index, tree_map, tree_unstack,
                                     torch_dtype)

#: keys of the leaves the model reads in fp32 whatever the compute dtype:
#: RMSNorm scales (layers.rmsnorm, the mixer's gated "norm" too), the MoE
#: router (routing runs in fp32), the mamba2 mixer's A_log, dt_bias and
#: D (fp32 in the decode step and in the decay terms), and the RG-LRU's
#: lam (its log-sigmoid decay runs in fp32)
_FP32_KEYS = frozenset({"ln1", "ln2", "ln", "final_norm", "norm", "router",
                        "A_log", "dt_bias", "D", "lam"})


# --------------------------------------------------------------------------- #
# remat policies
# --------------------------------------------------------------------------- #
#: the matrix products whose outputs "dots" keeps for the backward
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn: Callable, mode: str) -> Callable:
    """The JAX ``_remat`` (repro/models/transformer.py:40-49) in torch:
    "none" runs ``fn`` as it is; "full" keeps only its inputs and runs it
    again in the backward (``torch.utils.checkpoint``, JAX's
    nothing_saveable); "dots" keeps the outputs of its matrix products and
    recomputes the rest. Active only where grad mode is on: prefill and
    decode (inference mode) run ``fn`` as it is."""
    if mode not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat mode {mode}")
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    if mode == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=_save_dots)


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


def _attn_fn(p, cfg, sharder, positions, mode, window):
    """The block's attention; ``cfg.remat_attention`` nests a full remat
    around it (JAX ``_attn_fn``, transformer.py:117-123)."""
    fn = lambda h: attn.attention_block(p, cfg, sharder, h, positions,
                                        mode=mode, window=window)
    return _remat(fn, "full") if cfg.remat_attention else fn


def dense_block_fwd(p, cfg, sharder, x, positions, *, mode, window):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    h = sharder.sp_boundary(h)
    h = _attn_fn(p["attn"], cfg, sharder, positions, mode, window)(h)
    x = _res(sharder, x + h)
    h = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
    h = sharder.sp_boundary(h)
    h = L.mlp(p["mlp"], h, cfg.mlp_act, sharder)
    return _res(sharder, x + h)


def moe_block_fwd(p, cfg, sharder, x, positions, *, mode, window):
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    h = sharder.sp_boundary(h)
    h = _attn_fn(p["attn"], cfg, sharder, positions, mode, window)(h)
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
_DENSE = ("dense", "vlm", "audio")
#: families this port runs: every family the JAX package defines
_PORTED = (*_DENSE, "moe", "ssm", "hybrid")


def _unknown(cfg) -> ValueError:
    return ValueError(f"{cfg.name}: unknown family {cfg.family}")


class LM:
    def __init__(self, cfg):
        self.cfg = cfg

    # ---------------- param specs ---------------- #
    def param_specs(self) -> dict:
        cfg = self.cfg
        if cfg.family not in _PORTED:
            raise _unknown(cfg)
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

    # ---------------- full-sequence forward (train / prefill) ---------------- #
    def forward(self, params, batch, sharder) -> tuple[torch.Tensor, dict]:
        """batch {tokens [B,S] | embeds [B,S,Din], positions [B,S]}.
        Returns (logits [B,S,V], aux). Where grad mode is on, each block
        runs under ``cfg.remat`` (``_remat``), as the JAX forward's blocks
        do; under inference mode (prefill) the blocks run as they are. The
        stacks are unbound once (``tree_unstack``), so a backward stacks
        each leaf's gradients once."""
        cfg = self.cfg
        x = self._embed_in(params, batch, sharder)
        positions = batch["positions"]
        mode = "bidir" if cfg.encoder_only else "causal"
        remat = lambda fn: _remat(fn, cfg.remat)
        aux_a = torch.zeros((), dtype=torch.float32, device=x.device)
        aux_z = aux_a.clone()
        if cfg.family == "moe":
            dense = remat(lambda p, h: dense_block_fwd(
                p, cfg, sharder, h, positions, mode=mode, window=None))
            for p in (tree_unstack(params["dense_layers"])
                      if cfg.first_k_dense else []):
                x = dense(p, x)
            body = remat(lambda p, h: moe_block_fwd(
                p, cfg, sharder, h, positions, mode=mode, window=None))
            for p in tree_unstack(params["layers"]):
                x, a = body(p, x)
                aux_a = aux_a + a["moe_aux"]
                aux_z = aux_z + a["moe_z"]
        elif cfg.family == "ssm":
            body = remat(lambda p, h: ssm_block_fwd(p, cfg, sharder, h))
            for p in tree_unstack(params["layers"]):
                x = body(p, x)
        elif cfg.family == "hybrid":
            def super_fwd(p, h):
                h = rec_block_fwd(p["rec1"], cfg, sharder, h)
                h = rec_block_fwd(p["rec2"], cfg, sharder, h)
                return dense_block_fwd(p["attn"], cfg, sharder, h, positions,
                                       mode="causal", window=cfg.local_window)

            body = remat(super_fwd)
            for p in tree_unstack(params["superblocks"]):
                x = body(p, x)
            tail = remat(lambda p, h: rec_block_fwd(p, cfg, sharder, h))
            for key in sorted(params["tail"], key=int):
                x = tail(params["tail"][key], x)
        else:
            body = remat(lambda p, h: dense_block_fwd(
                p, cfg, sharder, h, positions, mode=mode, window=cfg.swa_window))
            for p in tree_unstack(params["layers"]):
                x = body(p, x)
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
        if cfg.family not in ("dense", "vlm"):
            raise _unknown(cfg)
        per = attn.cache_specs(cfg, batch, max_len, window=cfg.swa_window)
        return {"layers": _stack_specs(per, cfg.n_layers)}

    def reset_slot(self, cache: dict, i: int) -> None:
        """Put row ``i`` of every leaf of ``cache`` back to the value a
        fresh cache (``cache_specs`` through ``init_tree``) holds, in
        place: attention k, v zeros and pos -1; the mamba2 and RG-LRU conv
        buffers and states zeros. Each leaf's batch axis is the one its
        spec names ``kv_batch`` (after the stacked layer axis, if any)."""

        def reset(leaf, spec):
            if isinstance(leaf, dict):
                for key, sub in leaf.items():
                    reset(sub, spec[key])
                return
            fresh = {"zeros": 0, "ones": 1, "const": spec.scale}[spec.init]
            leaf.select(spec.axes.index("kv_batch"), i).fill_(fresh)

        reset(cache, self.cache_specs(1, 1))

    def attention_layers(self) -> int:
        """Attention layers a decode step runs, one decode-attention call
        each: the ``pos`` leaves of the cache, a stacked leaf counting each
        of its layers."""

        def count(specs):
            n = 0
            for key, spec in specs.items():
                if isinstance(spec, dict):
                    n += count(spec)
                elif key == "pos":
                    n += spec.shape[0] if spec.axes[0] == "layers" else 1
            return n

        return count(self.cache_specs(1, 1))

    def decode_step(self, params, cache, tokens, positions, sharder):
        """One token for every row. tokens [B] (or embeds [B,1,Din] for a
        non-token frontend); positions [B] int32 (or [3,B] M-RoPE streams).
        Returns (logits [B,V], cache), the cache updated in place."""
        cfg = self.cfg
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        cdt = torch_dtype(cfg.compute_dtype)
        if cfg.frontend == "token":
            x = L.embed(tokens[:, None], params["embed"]["tok"], cdt)
        else:
            x = L.frontend_proj(tokens.to(cdt), params["frontend"]["proj"])
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
        transformer.py:414-416); the hybrid passes its ``local_window``.
        [3,B] positions reach the attention whole under M-RoPE, else as
        their temporal stream."""
        cfg = self.cfg
        if positions.ndim == 2 and cfg.mrope_sections is None:
            positions = positions[0]
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
