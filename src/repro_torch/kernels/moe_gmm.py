"""K3, the grouped (per-expert) matrix product of the MoE expert FFNs:
``out[e] = x[e] @ w[e]``.

Port of ``repro/kernels/moe_gmm.py::moe_gmm``. For CUDA tensors
``moe_gmm`` launches one of the hand-written Hopper kernels in
``csrc/moe_gmm.cu`` (see the note at its top for the designs), the one
that ``_route`` picks; for CPU tensors it runs the plain version,
``ref.moe_gmm_ref``. There is no fallback: a CUDA call that no kernel
takes raises.

``moe_gmm.launches`` counts kernel launches (never plain calls) and
``moe_gmm.route_launches`` the same by route, so a run can show that its
expert products went through the kernel, and through which.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build, ref

#: the kernels of ``csrc/moe_gmm.cu`` (its ``route`` argument): fp32 on the
#: CUDA cores; bf16 through mma.sync; bf16 through TMA and wgmma, the
#: persistent prefill kernel and, for at most ``DECODE_ROWS`` rows, the
#: decode kernel (operands swapped)
_ROUTES = {"f32": 0, "mma": 1, "tma": 2, "tma_decode": 3}
_DTYPES = {"f32": torch.float32, "mma": torch.bfloat16, "tma": torch.bfloat16,
           "tma_decode": torch.bfloat16}
#: the most rows the decode kernel takes (DEC_ROWS in the source; the CPU
#: tests hold the two equal)
DECODE_ROWS = 16
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P,    # device, route, x w out
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
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got {x.dtype} "
                        f"and {w.dtype}")
    build.forbid_grad("moe_gmm", x, w)
    if x.device != w.device:
        raise ValueError(f"tensors on several devices: {x.device}, {w.device}")


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """Element strides of t [E, rows, cols]'s first two dims; a dim of
    extent 1 gets the stride of one past the others (it is never stepped,
    and a tensor map wants a multiple of 16 bytes)."""
    span = max(t.stride(d) * t.shape[d] for d in range(3))
    return tuple(t.stride(d) if t.shape[d] > 1 else span for d in (0, 1))


def _route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel that takes a call (a key of ``_ROUTES``): fp32 goes to
    the CUDA cores; bf16 goes to TMA and wgmma when D and F are multiples
    of 8 and every stride (of a dim longer than 1) and base is a multiple
    of 16 bytes, to the decode kernel at most ``DECODE_ROWS`` rows and to
    the prefill kernel above; the other bf16 calls go to mma.sync."""
    if x.dtype == torch.float32:
        return "f32"
    aligned = (x.shape[2] % 8 == 0 and w.shape[2] % 8 == 0
               and all(t.data_ptr() % 16 == 0
                       and all(s > 0 and s % 8 == 0 for s in _strides(t))
                       for t in (x, w)))
    if not aligned:
        return "mma"
    return "tma_decode" if x.shape[1] <= DECODE_ROWS else "tma"


def launch(x: torch.Tensor, w: torch.Tensor, route: str) -> torch.Tensor:
    """Launch the kernel of ``route`` on CUDA tensors x [E,C,D] and w
    [E,D,F] (``moe_gmm`` picks the route; the card's checks name each
    route that can take a case). Raises if the route cannot take it."""
    _check(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm kernels run on cuda, not {x.device}")
    if x.stride(2) != 1 or w.stride(2) != 1:
        raise ValueError("x and w need a contiguous last dim")
    if _DTYPES[route] != x.dtype:
        raise TypeError(f"route {route} takes {_DTYPES[route]}, not {x.dtype}")
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    fn, err_str = _kernel()
    err = fn(
        x.device.index, _ROUTES[route], x.data_ptr(), w.data_ptr(),
        out.data_ptr(), E, C, D, F, *_strides(x), *_strides(w),
        out.stride(0), out.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"moe_gmm kernel launch failed (route {route}): CUDA "
                           f"error {err} ({err_str(err).decode()})")
    with _count_lock:
        moe_gmm.launches += 1
        moe_gmm.route_launches[route] += 1
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E,C,D] (any expert and row strides, last dim contiguous on CUDA);
    w [E,D,F] -> [E,C,F] in x's dtype, summed in fp32."""
    _check(x, w)
    if x.device.type == "cpu":
        return ref.moe_gmm_ref(x, w)
    return launch(x, w, _route(x, w))


moe_gmm.launches = 0
moe_gmm.route_launches = dict.fromkeys(_ROUTES, 0)
