"""K3, the grouped (per-expert) matrix product of the MoE expert FFNs:
``out[e] = x[e] @ w[e]``.

Port of ``repro/kernels/moe_gmm.py::moe_gmm``. For CUDA tensors
``moe_gmm`` launches the hand-written Hopper kernel in ``csrc/moe_gmm.cu``
(see the note at its top for the design); for CPU tensors it runs the
plain version, ``ref.moe_gmm_ref``. There is no fallback: a CUDA call the
kernel cannot take raises.

``moe_gmm.launches`` counts kernel launches (never plain calls), so a run
can show that its expert products went through the kernel.
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
_ARGTYPES = [_I, _I, _P, _P, _P,    # device, dtype, x w out
             _I, _I, _I, _I,        # E C D F
             _L, _L, _L, _L, _L, _L,  # x, w, out strides (expert, row)
             _P]                    # stream


@functools.cache
def _kernel():
    lib = build.load("moe_gmm")
    fn = lib.repro_moe_gmm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def _check(x, w) -> None:
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"want x [E,C,D] and w [E,D,F], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    E, C, D = x.shape
    if w.shape[0] != E or w.shape[1] != D or 0 in (E, C, D, w.shape[2]):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got {x.dtype} "
                        f"and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"tensors on several devices: {x.device}, {w.device}")


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,D] (any expert and row strides, last dim contiguous on CUDA);
    w [E,D,F] -> [E,C,F] in x's dtype, summed in fp32."""
    _check(x, w)
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cuda (or cpu), not {x.device}")
    if x.stride(2) != 1 or w.stride(2) != 1:
        raise ValueError("x and w need a contiguous last dim")
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    fn, err_str = _kernel()
    err = fn(
        x.device.index, _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
        out.data_ptr(), E, C, D, F, x.stride(0), x.stride(1), w.stride(0),
        w.stride(1), out.stride(0), out.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"moe_gmm kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    with _count_lock:
        moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
