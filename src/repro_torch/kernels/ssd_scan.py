"""K4, the Mamba-2 SSD chunked scan.

Port of ``repro/kernels/ssd_scan.py::ssd_scan``. For CUDA tensors
``ssd_scan`` launches the hand-written Hopper kernel in ``csrc/ssd_scan.cu``
(see the note at its top for the design); for CPU tensors it runs the
plain version, ``ref.ssd_ref`` (the exact recurrence). There is no
fallback: a CUDA call the kernel cannot take raises.

``ssd_scan.launches`` counts kernel launches (never plain calls), so a run
can show that its scans went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel keeps the [P, N] state and its tiles in shared memory
_MAX_P, _MAX_N = 64, 128
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P,  # device, dtype, x dt A B C y h
             _I, _I, _I, _I, _I, _I,              # B S H P N Q
             _L, _L, _L, _L, _L, _L,              # x, dt strides (b, s, h)
             _L, _L, _L, _L,                      # B, C strides (b, s)
             _L, _L, _L,                          # y strides (b, s, h)
             _P]                                  # stream


@functools.cache
def _kernel():
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(x, dt, A, Bm, Cm, chunk) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 3:
        raise ValueError(f"want x [B,S,H,P], dt [B,S,H], A [H], B and C [B,S,N], "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape
            or 0 in (Bsz, S, H, P, N)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, B and C must share float32 or bfloat16, got "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    devs = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")


def ssd_scan(
    x: torch.Tensor,   # [B, S, H, P] (any strides, last dim contiguous)
    dt: torch.Tensor,  # [B, S, H] fp32, > 0
    A: torch.Tensor,   # [H] fp32, < 0
    Bm: torch.Tensor,  # [B, S, N] (last dim contiguous)
    Cm: torch.Tensor,  # [B, S, N]
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B,S,H,P] in x's dtype, final state [B,H,P,N] fp32)."""
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda (or cpu), not {x.device}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if P > _MAX_P or N > _MAX_N:
        raise ValueError(f"head dim {P} > {_MAX_P} or state {N} > {_MAX_N}")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("x, B and C need a contiguous last dim")
    A = A.contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    fn, err_str = _kernel()
    err = fn(
        x.device.index, _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h.data_ptr(),
        Bsz, S, H, P, N, min(chunk, S), *x.stride()[:3], *dt.stride(),
        *Bm.stride()[:2], *Cm.stride()[:2], *y.stride()[:3],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    with _count_lock:
        ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
