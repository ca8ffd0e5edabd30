"""K1, flash decode: one new token per row against a positional KV cache.

Port of ``repro/kernels/decode_attention.py::flash_decode``. For CUDA
tensors ``flash_decode`` launches the hand-written Hopper kernel in
``csrc/decode_attention.cu`` (see the note at its top for the design):
split-KV flash decoding, whose split of the cache ``_plan`` chooses, and a
combine kernel when there is more than one split. For CPU tensors it runs
the plain version, ``ref.flash_decode_ref``. There is no fallback: a CUDA
call the kernel cannot take raises.

``flash_decode.launches`` counts calls that launched the kernel (one a
call, with or without the combine; never plain calls), so a run can show
that its decode attention went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256


# slots a tile (a split is whole tiles); query heads a CTA; the combine's
# limit on splits: constants of the kernel's source, which the split plan
# shares with it
_TILE, _GROUP, _MAX_SPLITS = (build.cu_constant("decode_attention", c)
                              for c in ("TILE", "GC", "MAX_SPLITS"))
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P,  # device, dtype, q k v cpos qpos out
             _I, _I, _I, _I, _I,              # B H KV W D
             _L, _L, _L, _L, _L, _L,          # k strides, v strides (b, kv, w)
             _I, _I, _I, _P, _P]              # window, nsplit, split_len, ws, stream


@functools.cache
def _kernel():
    lib = build.load("decode_attention")
    fn = lib.repro_flash_decode
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    per_sm = lib.repro_flash_decode_ctas_per_sm
    per_sm.argtypes = [_I, _I, _I]
    per_sm.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string, per_sm


@functools.cache
def _slots(index: int, dtype_code: int, D: int) -> int:
    """CTAs of the kernel for this dtype and head dim that the card holds at
    once: its SMs times the CTAs an SM fits (CUDA's occupancy query)."""
    per_sm = _kernel()[2](index, dtype_code, D)
    if per_sm <= 0:
        raise RuntimeError(f"flash_decode: no occupancy for dtype "
                           f"{dtype_code}, D={D}")
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


def _plan(B: int, KV: int, G: int, W: int, slots: int) -> tuple[int, int]:
    """(nsplit, split_len): W cut into ``nsplit`` splits of ``split_len``
    slots (whole 64-slot tiles; the last split may be shorter), as many as
    one wave of ``slots`` CTAs holds (B * KV * ceil(G / 16) CTAs a split),
    where W has the tiles for it, and at most 128. One wave: each CTA pays
    its start (Q, the first tiles' latency) and its merge once, and no
    second wave runs on part of the card."""
    tiles = -(-W // _TILE)
    ctas = B * KV * -(-G // _GROUP)
    want = max(1, min(tiles, slots // ctas))
    per = max(-(-tiles // want), -(-tiles // _MAX_SPLITS))  # tiles a split
    return -(-tiles // per), per * _TILE


def _check(q, k_cache, v_cache, cache_pos, q_pos, window) -> None:
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"want q [B,H,D] and caches [B,KV,W,D], got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, D = q.shape
    KV, W = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or KV == 0 or H % KV):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if tuple(cache_pos.shape) != (B, W) or tuple(q_pos.shape) != (B,):
        raise ValueError(f"want cache_pos [{B},{W}] and q_pos [{B}], got "
                         f"{tuple(cache_pos.shape)} and {tuple(q_pos.shape)}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if cache_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("cache_pos and q_pos must be int32")
    build.forbid_grad("flash_decode", q, k_cache, v_cache)
    devs = {t.device for t in (q, k_cache, v_cache, cache_pos, q_pos)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_decode(
    q: torch.Tensor,          # [B, H, D] one token per row
    k_cache: torch.Tensor,    # [B, KV, W, D] (any strides, last dim contiguous)
    v_cache: torch.Tensor,    # [B, KV, W, D]
    cache_pos: torch.Tensor,  # [B, W] int32 absolute positions (-1 empty)
    q_pos: torch.Tensor,      # [B] int32 absolute position of the new token
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    _check(q, k_cache, v_cache, cache_pos, q_pos, window)
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, cache_pos, q_pos,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda (or cpu), not {q.device}")
    B, H, D = q.shape
    KV, W = k_cache.shape[1], k_cache.shape[2]
    if D > _MAX_D:
        raise ValueError(f"head dim {D} > {_MAX_D}")
    if not (q.is_contiguous() and cache_pos.is_contiguous()
            and q_pos.is_contiguous()):
        raise ValueError("q, cache_pos and q_pos must be contiguous")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("k_cache and v_cache need a contiguous last dim")
    index = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    nsplit, split_len = _plan(B, KV, H // KV, W,
                              _slots(index, _DTYPE_CODE[q.dtype], D))
    out = torch.empty_like(q)
    # the splits' partial accumulators [B,H,nsplit,D] and (m, l) [B,H,nsplit,2]
    ws = (torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                      device=q.device) if nsplit > 1 else None)
    fn, err_str, _ = _kernel()
    err = fn(
        index, _DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), cache_pos.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, H, KV, W, D,
        *k_cache.stride()[:3], *v_cache.stride()[:3],
        -1 if window is None else int(window), nsplit, split_len,
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    with _count_lock:
        flash_decode.launches += 1
    return out


flash_decode.launches = 0
