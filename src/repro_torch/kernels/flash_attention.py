"""K2, flash attention forward: blocked GQA attention over a full sequence
(prefill), causal, sliding-window or bidirectional.

Port of ``repro/kernels/flash_attention.py::flash_attention_fwd``. For CUDA
tensors ``flash_attention_fwd`` launches the hand-written Hopper kernel in
``csrc/flash_attention.cu`` (see the note at its top for the design); for
CPU tensors it runs the plain version, ``ref.flash_attention_ref``. There
is no fallback: a CUDA call the kernel cannot take raises.

``flash_attention_fwd.launches`` counts kernel launches (never plain
calls), so a run can show that its attention went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dim of each path: the bf16 kernel keeps a warp's output
#: rows in registers, the fp32 one stages rows in shared memory
_MAX_D = {torch.float32: 256, torch.bfloat16: 128}
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P,    # device, dtype, q k v out
             _I, _I, _I, _I, _I, _I,    # B H KV Sq Sk D
             _L, _L, _L, _L, _L, _L,    # q strides, k strides (b, s, h)
             _L, _L, _L, _L, _L, _L,    # v strides, out strides
             _I, _I, _P]                # causal, window, stream


@functools.cache
def _kernel():
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(q, k, v, window) -> None:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"want q [B,H,Sq,D] and k, v [B,KV,Sk,D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or KV == 0 or H % KV or Sq == 0 or Sk == 0):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_fwd(
    q: torch.Tensor,   # [B, H, Sq, D] (any strides, last dim contiguous)
    k: torch.Tensor,   # [B, KV, Sk, D]
    v: torch.Tensor,   # [B, KV, Sk, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """[B, H, Sq, D] in q's dtype. On CUDA it is a view of a [B, Sq, H, D]
    tensor, the model layout, which the kernel writes directly."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda (or cpu), not "
                         f"{q.device}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if D > _MAX_D[q.dtype]:
        raise ValueError(f"head dim {D} > {_MAX_D[q.dtype]} for {q.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a contiguous last dim")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    fn, err_str = _kernel()

    def bsh(t):  # element strides of batch, sequence and head
        return t.stride(0), t.stride(2), t.stride(1)

    err = fn(
        q.device.index, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk, D,
        *bsh(q), *bsh(k), *bsh(v), out.stride(0), out.stride(1), out.stride(2),
        int(bool(causal)), -1 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    with _count_lock:
        flash_attention_fwd.launches += 1
    return out.transpose(1, 2)


flash_attention_fwd.launches = 0
