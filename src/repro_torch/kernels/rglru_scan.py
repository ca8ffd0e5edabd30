"""K5, the RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t.

Port of ``repro/kernels/rglru_scan.py::rglru_scan_kernel``, with two
entries into the hand-written Hopper kernels of ``csrc/rglru_scan.cu`` (see
the note at its top for the designs):

- ``rglru_scan(a, b, h0)``, the TPU kernel's function, on the route that
  ``_route`` picks: "ring" (rglru_ring, a ring of cp.async tiles) where the
  copies can go, "fwd" (rglru_fwd, one thread a channel) off their
  alignment;
- ``rglru_gated(r, i, x, log_a_base, h0)``, the model's entry on the card
  (``models/rglru.py::gated_scan``): the decay and gated input formed in
  registers from the gates (``ref.rglru_decay_input``), then the same scan,
  always on the ring.

For CPU tensors each runs its plain version, ``ref.rglru_ref`` or
``ref.rglru_gated_ref``. There is no fallback: a CUDA call that no route
takes raises.

``rglru_scan.launches`` counts calls that launched a kernel (never plain
calls; one a call of either entry) and ``rglru_scan.route_launches`` the
same by entry and route (``"scan ring"``, ``"scan fwd"``, ``"gated
ring"``), so a run can show that its scans went through the kernels, and
through which.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels of ``csrc/rglru_scan.cu``: "ring", rglru_ring (both entries,
#: 16-byte copies); "fwd", rglru_fwd (the first entry, any strides)
ROUTES = ("ring", "fwd")
_count_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P,  # device, dtype, a b h0 y hout
             _I, _I, _I,                  # B S W
             _L, _L, _L, _L,              # a, b strides (b, s)
             _P]                          # stream
_GATED_ARGTYPES = [_I, _I, *[_P] * 7,     # device, dtype, r i x lab h0 y hout
                   _I, _I, _I,            # B S W
                   *[_L] * 6,             # r, i, x strides (b, s)
                   _P]                    # stream


@functools.cache
def _kernel():
    lib = build.load("rglru_scan")
    fns = {"fwd": lib.repro_rglru_scan, "ring": lib.repro_rglru_ring,
           "gated": lib.repro_rglru_gated}
    for name, fn in fns.items():
        fn.argtypes = _GATED_ARGTYPES if name == "gated" else _ARGTYPES
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fns, lib.repro_cuda_error_string


def _check(names: str, streams, h0) -> None:
    if any(t.ndim != 3 for t in streams) or h0.ndim != 2:
        raise ValueError(f"want {names} [B,S,W] and h0 [B,W], got "
                         f"{[tuple(t.shape) for t in streams]}, {tuple(h0.shape)}")
    Bsz, S, W = streams[0].shape
    if (any(t.shape != streams[0].shape for t in streams)
            or tuple(h0.shape) != (Bsz, W) or 0 in (Bsz, S, W)):
        raise ValueError(f"shape mismatch: {names} {[tuple(t.shape) for t in streams]}, "
                         f"h0 {tuple(h0.shape)}")
    dtype = streams[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in streams):
        raise TypeError(f"{names} must share float32 or bfloat16, got "
                        f"{[t.dtype for t in streams]}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32, got {h0.dtype}")
    build.forbid_grad("rglru_scan", *streams, h0)
    devs = {t.device for t in (*streams, h0)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _strides(t: torch.Tensor) -> list[int]:
    """Element strides of t's dims but the last; a dim of extent 1 gets 0
    (it is never stepped)."""
    return [t.stride(d) if t.shape[d] > 1 else 0 for d in range(t.ndim - 1)]


def _route(*streams: torch.Tensor) -> str:
    """The route that takes a call (a name in ``ROUTES``): "ring" when W and
    every stream's strides (of dims longer than 1) are whole 16-byte chunks
    and every stream has a 16-byte aligned base and a contiguous last dim
    (rglru_ring copies and stores 16 bytes at a time); "fwd" otherwise."""
    v = 16 // streams[0].element_size()
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(-1) == 1
                  and all(s % v == 0 for s in _strides(t)) for t in streams)
    return "ring" if aligned and streams[0].shape[-1] % v == 0 else "fwd"


def _count(key: str) -> None:
    with _count_lock:
        rglru_scan.launches += 1
        rglru_scan.route_launches[key] += 1


def _raise_on(err: int, err_str, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")


def launch(a, b, h0, route: str):
    """The first entry's kernel of ``route`` on CUDA tensors (``rglru_scan``
    picks the route; the card's checks name each route that can take a
    case). Raises if the route cannot take the call."""
    _check("a, b", (a, b), h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan kernels run on cuda, not {a.device}")
    if a.stride(2) != 1 or b.stride(2) != 1:
        raise ValueError("a and b need a contiguous last dim")
    if route not in ROUTES:
        raise ValueError(f"no route {route!r}; routes are {ROUTES}")
    if route == "ring" and _route(a, b) != "ring":
        raise ValueError("route ring takes 16-byte aligned bases and rows "
                         f"(W = {a.shape[2]} of {a.dtype}, strides "
                         f"{_strides(a)}, {_strides(b)})")
    Bsz, S, W = a.shape
    h0 = h0.contiguous()
    y = torch.empty((Bsz, S, W), dtype=a.dtype, device=a.device)
    h = torch.empty((Bsz, W), dtype=torch.float32, device=a.device)
    fns, err_str = _kernel()
    err = fns[route](
        a.device.index, _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h.data_ptr(), Bsz, S, W,
        *_strides(a), *_strides(b),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _raise_on(err, err_str, f"rglru_scan (route {route})")
    _count(f"scan {route}")
    return y, h


def rglru_scan(
    a: torch.Tensor,   # [B, S, W] decay in (0, 1) (any strides, last dim contiguous)
    b: torch.Tensor,   # [B, S, W] gated input, a's dtype
    h0: torch.Tensor,  # [B, W] fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B,S,W] in a's dtype, final state [B,W] fp32)."""
    _check("a, b", (a, b), h0)
    if a.device.type == "cpu":
        return ref.rglru_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda (or cpu), not {a.device}")
    return launch(a, b, h0, _route(a, b))


def rglru_gated(
    r: torch.Tensor,           # [B, S, W] recurrence gate sigmoid(W_a x + b_a)
    i: torch.Tensor,           # [B, S, W] input gate, r's dtype
    x: torch.Tensor,           # [B, S, W] the block's input, r's dtype
    log_a_base: torch.Tensor,  # [W] fp32, log sigmoid(lambda)
    h0: torch.Tensor,          # [B, W] fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y [B,S,W] in x's dtype, final state [B,W] fp32) of the scan of
    ``ref.rglru_decay_input(r, i, x, log_a_base)`` from h0. On CUDA tensors
    the gated entry of rglru_ring, which takes 16-byte aligned bases and
    rows (``_route``) and raises off them."""
    _check("r, i, x", (r, i, x), h0)
    W = x.shape[2]
    if tuple(log_a_base.shape) != (W,) or log_a_base.dtype != torch.float32:
        raise ValueError(f"log_a_base must be [{W}] float32, got "
                         f"{tuple(log_a_base.shape)} {log_a_base.dtype}")
    build.forbid_grad("rglru_gated", log_a_base)
    if log_a_base.device != x.device:
        raise ValueError(f"log_a_base on {log_a_base.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.rglru_gated_ref(r, i, x, log_a_base, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_gated runs on cuda (or cpu), not {x.device}")
    if _route(r, i, x) != "ring":
        raise ValueError("rglru_gated takes 16-byte aligned bases and rows with a "
                         f"contiguous last dim (W = {W} of {x.dtype}, strides "
                         f"{_strides(r)}, {_strides(i)}, {_strides(x)})")
    Bsz, S, _ = x.shape
    lab, h0 = log_a_base.contiguous(), h0.contiguous()
    y = torch.empty((Bsz, S, W), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, W), dtype=torch.float32, device=x.device)
    fns, err_str = _kernel()
    err = fns["gated"](
        x.device.index, _DTYPE_CODE[x.dtype], r.data_ptr(), i.data_ptr(),
        x.data_ptr(), lab.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        Bsz, S, W, *_strides(r), *_strides(i), *_strides(x),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, err_str, "rglru_gated")
    _count("gated ring")
    return y, h


rglru_scan.launches = 0
rglru_scan.route_launches = dict.fromkeys(("scan ring", "scan fwd", "gated ring"), 0)
