"""K2, flash attention forward: blocked GQA attention over a full sequence
(prefill), causal, sliding-window or bidirectional.

Port of ``repro/kernels/flash_attention.py::flash_attention_fwd``. For CUDA
tensors ``flash_attention_fwd`` launches one of the hand-written Hopper
kernels in ``csrc/flash_attention.cu`` (see the note at its top for the
designs), the one that ``_route`` picks; for CPU tensors it runs the plain
version, ``ref.flash_attention_ref``. There is no fallback: a CUDA call
that no kernel takes raises.

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

#: the kernels of ``csrc/flash_attention.cu`` (its ``route`` argument)
_ROUTES = {"f32": 0, "mma": 1, "tma": 2}
#: the head dims each kernel takes. f32 (CUDA cores) stages rows in shared
#: memory: any D up to 256. tma (bf16: TMA, wgmma) loads 64-column panels
#: through tensor maps, whose strides are multiples of 16 bytes: D a
#: multiple of 8 up to 128, or 256 (recurrentgemma-9b). mma (bf16,
#: mma.sync) keeps a warp's output rows in registers, D padded to a
#: multiple of 16 in shared memory: D <= 128 or D = 256, for the bf16 calls
#: that TMA cannot take (strides or bases off 16 bytes, as at D = 20)
_HEAD_DIMS = {"f32": frozenset(range(1, 257)),
              "tma": frozenset((*range(8, 129, 8), 256)),
              "mma": frozenset((*range(1, 129), 256))}
_DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P,    # device, route, q k v out
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    build.forbid_grad("flash_attention_fwd", q, k, v)
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _bsh(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of t [B, heads, S, D]'s batch, sequence and head
    dims; a dim of extent 1 gets the stride of one past the others (it is
    never stepped, and a tensor map wants a multiple of 16 bytes)."""
    dims = (0, 2, 1)
    span = max(t.stride(d) * t.shape[d] for d in range(4))
    return tuple(t.stride(d) if t.shape[d] > 1 else span for d in dims)


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes a CUDA call (a key of ``_ROUTES``): fp32 goes
    to the CUDA cores; bf16 goes to TMA and wgmma when its head dim is
    built there and every stride (of a dim longer than 1) and base is a
    multiple of 16 bytes, and to mma.sync otherwise. Raises ValueError for
    what neither takes."""
    D = q.shape[3]
    if q.dtype == torch.float32:
        route = "f32"
    else:
        aligned = all(t.data_ptr() % 16 == 0
                      and all(s > 0 and s * t.element_size() % 16 == 0
                              for s in _bsh(t))
                      for t in (q, k, v))
        route = "tma" if aligned and D in _HEAD_DIMS["tma"] else "mma"
    if D not in _HEAD_DIMS[route]:
        raise ValueError(
            f"head dim {D}: the {q.dtype} kernels take "
            + ("D <= 256" if route == "f32" else "D <= 128 or D = 256"))
    return route


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
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a contiguous last dim")
    route = _route(q, k, v)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    fn, err_str = _kernel()
    err = fn(
        q.device.index, _ROUTES[route], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk, D,
        *_bsh(q), *_bsh(k), *_bsh(v), *_bsh(out.transpose(1, 2)),
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
