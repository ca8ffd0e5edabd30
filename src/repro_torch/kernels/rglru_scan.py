"""K5, the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t.

Port of ``repro/kernels/rglru_scan.py::rglru_scan_kernel``. For CUDA
tensors ``rglru_scan`` launches the hand-written Hopper kernel in
``csrc/rglru_scan.cu`` (see the note at its top for the design); for CPU
tensors it runs the plain version, ``ref.rglru_ref`` (the exact step
recurrence). There is no fallback: a CUDA call the kernel cannot take
raises.

``rglru_scan.launches`` counts kernel launches (never plain calls), so a
run can show that its scans went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P,  # device, dtype, a b h0 y hout
             _I, _I, _I,                  # B S W
             _L, _L, _L, _L,              # a, b strides (b, s)
             _P]                          # stream


@functools.cache
def _kernel():
    lib = build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(a, b, h0) -> None:
    if a.ndim != 3 or h0.ndim != 2:
        raise ValueError(f"want a, b [B,S,W] and h0 [B,W], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h0.shape)}")
    Bsz, S, W = a.shape
    if b.shape != a.shape or tuple(h0.shape) != (Bsz, W) or 0 in (Bsz, S, W):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"a and b must share float32 or bfloat16, got {a.dtype}, "
                        f"{b.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")
    devs = {t.device for t in (a, b, h0)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def rglru_scan(
    a: torch.Tensor,   # [B, S, W] decay in (0, 1) (any strides, last dim contiguous)
    b: torch.Tensor,   # [B, S, W] gated input, a's dtype
    h0: torch.Tensor,  # [B, W] fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B,S,W] in a's dtype, final state [B,W] fp32)."""
    _check(a, b, h0)
    if a.device.type == "cpu":
        return ref.rglru_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda (or cpu), not {a.device}")
    Bsz, S, W = a.shape
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("a and b need a contiguous last dim")
    h0 = h0.contiguous()
    y = torch.empty((Bsz, S, W), dtype=a.dtype, device=a.device)
    h = torch.empty((Bsz, W), dtype=torch.float32, device=a.device)
    fn, err_str = _kernel()
    err = fn(
        a.device.index, _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), Bsz, S, W,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    with _count_lock:
        rglru_scan.launches += 1
    return y, h


rglru_scan.launches = 0
