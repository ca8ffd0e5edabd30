"""K4, the Mamba-2 SSD chunked scan.

Port of ``repro/kernels/ssd_scan.py::ssd_scan``. For CUDA tensors
``ssd_scan`` launches the hand-written Hopper kernels of ``csrc/ssd_scan.cu``
(see the note at its top for the designs) on the route that ``_route``
picks; for CPU tensors it runs the plain version, ``ref.ssd_ref`` (the exact
recurrence). There is no fallback: a CUDA call that no route takes raises.

``ssd_scan.launches`` counts calls that launched the kernels (never plain
calls; one a call, whatever the route launches) and
``ssd_scan.route_launches`` the same by route, so a run can show that its
scans went through the kernels, and through which.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the routes of ``csrc/ssd_scan.cu``: "tc", the chunked SSD algorithm on
#: tensor cores (three kernels: chunk states, a state pass, chunk outputs;
#: bf16 x, B and C); "fwd", ssd_fwd, one CTA per (head, row) walking
#: the chunks on the CUDA cores (fp32, and bf16 off route tc's alignment)
ROUTES = ("tc", "fwd")
#: ssd_fwd keeps the [P, N] state and its tiles in shared memory
_MAX_P, _MAX_N = 64, 128
#: route tc's limits (TC_PM, TC_NM, TC_QM in the source; the CPU tests hold
#: them equal); P and N also multiples of 16
TC_MAX_P, TC_MAX_N, TC_MAX_Q = 64, 128, 256
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _P,  # device, dtype, x dt A B C y h
             _I, _I, _I, _I, _I, _I,              # B S H P N Q
             _L, _L, _L, _L, _L, _L,              # x, dt strides (b, s, h)
             _L, _L, _L, _L,                      # B, C strides (b, s)
             _L, _L, _L,                          # y strides (b, s, h)
             _P]                                  # stream
# route tc: x dt A B C y h, then the workspaces st and cd
_TC_ARGTYPES = [_I, *[_P] * 9, *_ARGTYPES[9:]]


@functools.cache
def _kernel():
    lib = build.load("ssd_scan")
    fns = {"fwd": lib.repro_ssd_scan, "tc": lib.repro_ssd_scan_tc}
    fns["fwd"].argtypes = _ARGTYPES
    fns["tc"].argtypes = _TC_ARGTYPES
    for fn in fns.values():
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fns, lib.repro_cuda_error_string


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
    build.forbid_grad("ssd_scan", x, dt, A, Bm, Cm)
    devs = {t.device for t in (x, dt, A, Bm, Cm)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")


def _strides(t: torch.Tensor) -> list[int]:
    """Element strides of t's dims but the last; a dim of extent 1 gets 0
    (it is never stepped)."""
    return [t.stride(d) if t.shape[d] > 1 else 0 for d in range(t.ndim - 1)]


def _route(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> str:
    """The route that takes a call (a name in ``ROUTES``): bf16 x, B and C
    go to "tc" when P and N are multiples of 16 within TC_MAX_P and
    TC_MAX_N, the chunk is at most TC_MAX_Q, and each of x, B and C has a
    16-byte aligned base, a contiguous last dim and strides (of dims longer
    than 1) that are multiples of 8 elements; every other call goes to
    "fwd"."""
    if x.dtype != torch.bfloat16:
        return "fwd"
    S, P, N = x.shape[1], x.shape[3], Bm.shape[2]
    fits = (P % 16 == 0 and N % 16 == 0 and P <= TC_MAX_P and N <= TC_MAX_N
            and min(chunk, S) <= TC_MAX_Q)
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(-1) == 1
                  and all(s % 8 == 0 for s in _strides(t)) for t in (x, Bm, Cm))
    return "tc" if fits and aligned else "fwd"


def launch(x, dt, A, Bm, Cm, chunk: int, route: str):
    """Launch the kernels of ``route`` on CUDA tensors (``ssd_scan`` picks
    the route; the card's checks name each route that can take a case).
    Raises if the route cannot take the call."""
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan kernels run on cuda, not {x.device}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if route == "tc" and _route(x, Bm, Cm, chunk) != "tc":
        raise ValueError(f"route tc takes bf16 with P, N multiples of 16 (<= "
                         f"{TC_MAX_P}, {TC_MAX_N}), Q <= {TC_MAX_Q} and 16-byte "
                         f"rows, not {x.dtype} P={P} N={N} Q={Q}")
    if P > _MAX_P or N > _MAX_N:
        raise ValueError(f"head dim {P} > {_MAX_P} or state {N} > {_MAX_N}")
    if x.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("x, B and C need a contiguous last dim")
    A = A.contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    fns, err_str = _kernel()
    args = (Bsz, S, H, P, N, Q, *_strides(x), *dt.stride(), *_strides(Bm),
            *_strides(Cm), *y.stride()[:3],
            torch.cuda.current_stream(x.device).cuda_stream)
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h.data_ptr())
    if route == "tc":
        nc = S // Q
        st = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32, device=x.device)
        cd = torch.empty((Bsz, nc, H, 2, TC_MAX_Q), dtype=torch.float32,
                         device=x.device)
        err = fns["tc"](x.device.index, *ptrs, st.data_ptr(), cd.data_ptr(), *args)
    else:
        err = fns["fwd"](x.device.index, _DTYPE_CODE[x.dtype], *ptrs, *args)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed (route {route}): CUDA "
                           f"error {err} ({err_str(err).decode()})")
    with _count_lock:
        ssd_scan.launches += 1
        ssd_scan.route_launches[route] += 1
    return y, h


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
    return launch(x, dt, A, Bm, Cm, chunk, _route(x, Bm, Cm, chunk))


ssd_scan.launches = 0
ssd_scan.route_launches = dict.fromkeys(ROUTES, 0)
