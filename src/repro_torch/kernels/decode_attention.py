"""K1, flash decode: one new token per row against a positional KV cache.

Port of ``repro/kernels/decode_attention.py::flash_decode``. For CUDA
tensors ``flash_decode`` launches the hand-written Hopper kernel in
``csrc/decode_attention.cu`` (see the note at its top for the design); for
CPU tensors it runs the plain version, ``ref.flash_decode_ref``. There is
no fallback: a CUDA call the kernel cannot take raises.

``flash_decode.launches`` counts kernel launches (never plain calls), so a
run can show that its decode attention went through the kernel.
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
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P,  # device, dtype, q k v cpos qpos out
             _I, _I, _I, _I, _I,              # B H KV W D
             _L, _L, _L, _L, _L, _L,          # k strides, v strides (b, kv, w)
             _I, _P]                          # window, stream


@functools.cache
def _kernel():
    lib = build.load("decode_attention")
    fn = lib.repro_flash_decode
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


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
    out = torch.empty_like(q)
    fn, err_str = _kernel()
    err = fn(
        q.device.index, _DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), cache_pos.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), B, H, KV, W, D,
        *k_cache.stride()[:3], *v_cache.stride()[:3],
        -1 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    with _count_lock:
        flash_decode.launches += 1
    return out


flash_decode.launches = 0
