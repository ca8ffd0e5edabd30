"""K5 parity: the port's rglru_ref and ops.rglru (the plain version on the
CPU) against the JAX Pallas kernel in interpret mode and the JAX oracle, on
the same numpy inputs; the gated entry's plain version on the port's gates
against the JAX model's scan; the model's CPU scan against the recurrence;
a torch walk of the ring kernel's tiles (``_emulate_ring``) against the
recurrence, with a planted fault that the card's check must catch; the
routing point and the ring's shared-memory plan (read from the source);
and, on a CUDA card, each route and the gated entry against the plain
versions.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.models import rglru as tmodel
from repro_torch.models.rglru import associative_scan

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

# tests/test_kernels.py's tolerances: fp32 2e-5 (the same fp32 steps in
# another order of operations), bf16 a and b 2e-2 (one bf16 rounding of y)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

#: tests/test_kernels.py:160: (B, S, W), multiples of the TPU kernel's blocks
CASES = {"B1 S64 W128": (1, 64, 128), "B2 S128 W256": (2, 128, 256),
         "B1 S32 W128": (1, 32, 128)}
#: lengths and widths the TPU kernel does not take (it asserts W % 128 == 0
#: and S % blk_s == 0); the port masks them
RAGGED = {"B2 S37 W100": (2, 37, 100), "B1 S300 W129": (1, 300, 129),
          "B3 S1 W7": (3, 1, 7)}


def _inputs(seed, B, S, W):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, W))))).astype(np.float32)
    b = (rng.normal(size=(B, S, W)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0


def _torch(arrays, dtype):
    """a and b in ``dtype``; h0 fp32."""
    a, b, h0 = (torch.from_numpy(x) for x in arrays)
    low = getattr(torch, dtype)
    return a.to(low), b.to(low), h0


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_rglru", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: K5's criterion on the card (chip_smoke.rglru_close), for the emulation too
rglru_close = _chip_smoke().rglru_close


def _gated_inputs(seed, B, S, W, dtype):
    """r and i = sigmoid(N(0,1)) and x = N(0,1) in ``dtype``; log_a_base =
    log sigmoid(lambda) with lambda ~ 0.5 N(0,1) (the specs' init), h0 =
    N(0,1), both fp32."""
    rng = np.random.default_rng(seed)
    low = getattr(torch, dtype)
    r, i = (torch.from_numpy(1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, W))))).to(low)
            for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(B, S, W))).to(low)
    lab = F.logsigmoid(torch.from_numpy(rng.normal(scale=0.5, size=W)).float())
    h0 = torch.from_numpy(rng.normal(size=(B, W))).float()
    return r, i, x, lab, h0


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_rglru_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    arrays = _inputs(len(case), *CASES[case])
    low = getattr(jnp, dtype)
    ja, jb = (jnp.asarray(x).astype(low) for x in arrays[:2])
    jh0 = jnp.asarray(arrays[2])
    want = {"kernel": jops.rglru(ja, jb, jh0, interpret=True),
            "oracle": jref.rglru_ref(ja, jb, jh0)}
    tin = _torch(arrays, dtype)
    got = {"ops": tops.rglru(*tin), "ref": tref.rglru_ref(*tin)}
    for name, (y, h) in got.items():
        assert y.dtype == tin[0].dtype and h.dtype == torch.float32, name
        for wy, wh in want.values():
            _close(y, wy, TOL[dtype])
            _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", RAGGED)
def test_plain_rglru_at_ragged_shapes_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref

    arrays = _inputs(len(case), *RAGGED[case])
    low = getattr(jnp, dtype)
    wy, wh = jref.rglru_ref(jnp.asarray(arrays[0]).astype(low),
                            jnp.asarray(arrays[1]).astype(low),
                            jnp.asarray(arrays[2]))
    y, h = tops.rglru(*_torch(arrays, dtype))
    assert y.shape == RAGGED[case]
    _close(y, wy, TOL[dtype])
    _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100, 257])
def test_model_scan_matches_the_recurrence_at_any_length(S):
    """The model's CPU algorithm (a log-depth doubling scan from h = 0)
    against the step recurrence."""
    a, b, _ = (torch.from_numpy(x) for x in _inputs(S, 2, S, 24))
    want, _ = tref.rglru_ref(a, b, torch.zeros(2, 24))
    torch.testing.assert_close(associative_scan(a, b), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "h0_dtype", "device",
                                 "shape", "h0_shape", "empty", "rank"])
def test_rglru_rejects_what_the_kernel_cannot_take(bad):
    a, b, h0 = _torch(_inputs(0, 2, 16, 8), "float32")
    if bad == "dtype":
        a, b = a.half(), b.half()
    elif bad == "mixed_dtype":
        b = b.bfloat16()
    elif bad == "h0_dtype":
        h0 = h0.bfloat16()
    elif bad == "device":
        b = b.to("meta")
    elif bad == "shape":
        b = b[:, :8]
    elif bad == "h0_shape":
        h0 = h0[:1]
    elif bad == "empty":
        a, b = a[:, :0], b[:, :0]
    else:
        a, b = a[0], b[0]
    with pytest.raises((TypeError, ValueError)):
        tops.rglru(a, b, h0)


def test_plain_calls_do_not_count_as_launches():
    before = trg.rglru_scan.launches, dict(trg.rglru_scan.route_launches)
    tops.rglru(*_torch(_inputs(0, 1, 16, 8), "float32"))
    tops.rglru_gated(*_gated_inputs(0, 1, 16, 8, "float32"))
    assert (trg.rglru_scan.launches, trg.rglru_scan.route_launches) == before


# --------------------------------------------------------------------------- #
# the gated entry: its plain version against the JAX model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", TOL)
def test_gated_ref_on_the_ports_gates_matches_the_jax_model(dtype, with_h0):
    """ref.rglru_gated_ref, fed with r and i from the port's ``_gates``,
    against the JAX model's ``rglru_scan`` on the same numpy weights and
    inputs (it folds h0 into the first step and runs an associative scan):
    within TOL[dtype], fp32 2e-5 for the scan's order and bf16 2e-2 for one
    bf16 rounding of y (and of r and i, which both frameworks round from
    fp32 sums in their own order)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import rglru as jmodel

    B, S, nh, hd = 2, 40, 4, 16
    W = nh * hd
    rng = np.random.default_rng(7)
    params = {"wa": rng.normal(size=(nh, hd, hd)) / np.sqrt(hd),
              "ba": rng.normal(scale=0.3, size=(nh, hd)),
              "wx": rng.normal(size=(nh, hd, hd)) / np.sqrt(hd),
              "bx": rng.normal(scale=0.3, size=(nh, hd)),
              "lam": rng.normal(scale=0.5, size=W)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32) if with_h0 else None
    cfg = SimpleNamespace(lru_width=W, d_model=W, n_heads=nh)
    wy, wh = jmodel.rglru_scan({k: jnp.asarray(v) for k, v in params.items()}, cfg,
                               jnp.asarray(x).astype(getattr(jnp, dtype)),
                               None if h0 is None else jnp.asarray(h0))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    r, i = tmodel._gates(tp, tx.reshape(B, S, nh, hd))
    assert r.dtype == i.dtype == tx.dtype  # cast inside the formula
    y, h = tref.rglru_gated_ref(
        r.reshape(B, S, W), i.reshape(B, S, W), tx, F.logsigmoid(tp["lam"]),
        torch.zeros(B, W) if h0 is None else torch.from_numpy(h0))
    assert y.dtype == tx.dtype and h.dtype == torch.float32
    _close(y, wy, TOL[dtype])
    _close(h, wh, TOL[dtype])


@pytest.mark.parametrize("dtype", TOL)
def test_gated_entry_on_the_cpu_is_its_plain_version(dtype):
    ins = _gated_inputs(3, 2, 37, 40, dtype)
    y, h = tops.rglru_gated(*ins)
    wy, wh = tref.rglru_gated_ref(*ins)
    assert y.dtype == ins[2].dtype
    torch.testing.assert_close(y, wy, rtol=0, atol=0)
    torch.testing.assert_close(h, wh, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["lab_shape", "lab_dtype", "mixed_dtype", "dtype",
                                 "shape", "h0_dtype", "device"])
def test_gated_entry_rejects_what_the_kernel_cannot_take(bad):
    r, i, x, lab, h0 = _gated_inputs(0, 2, 16, 8, "bfloat16")
    if bad == "lab_shape":
        lab = lab[:4]
    elif bad == "lab_dtype":
        lab = lab.bfloat16()
    elif bad == "mixed_dtype":
        x = x.float()
    elif bad == "dtype":
        r, i, x = r.half(), i.half(), x.half()
    elif bad == "shape":
        i = i[:, :8]
    elif bad == "h0_dtype":
        h0 = h0.bfloat16()
    else:
        lab = lab.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tops.rglru_gated(r, i, x, lab, h0)


# --------------------------------------------------------------------------- #
# the ring kernel: its plan, its routing point and its walk of the tiles
# --------------------------------------------------------------------------- #
RING = {c: build.cu_constant("rglru_scan", c)
        for c in ("RING_T", "RING_CW", "RING_THREADS", "RING_BYTES", "MAX_SMEM")}
H100_SMS = 132


def _ring_plan(es, gated):
    """csrc/rglru_scan.cu Ring<T, GATED>: stage bytes, stages, shared memory,
    16-byte chunks a step, chunks a thread (a stream), steps between them."""
    T, Cw, NT = RING["RING_T"], RING["RING_CW"], RING["RING_THREADS"]
    ns = 3 if gated else 2
    tile = T * Cw
    stage = ns * tile * es
    nst = max(3, RING["RING_BYTES"] // stage)
    smem = nst * stage + (2 * tile * 4 if gated else 0) + tile * es
    row_chunks = Cw // (16 // es)
    return {"stage": stage, "nst": nst, "smem": smem, "row_chunks": row_chunks,
            "per": tile // (16 // es) // NT, "rstep": NT // row_chunks}


@pytest.mark.parametrize("es", [4, 2])
@pytest.mark.parametrize("gated", [False, True])
def test_ring_plan_fits_the_card(gated, es):
    """The ring's shared memory within the 232,448 bytes a block may use,
    two CTAs an SM (228 KB of shared memory an SM, 1 KB of it reserved a
    block), at least 64 KB of copies in flight an SM (NST - 1 stages a CTA),
    a grid of 256 CTAs at recurrentgemma-9b's B=4 W=4096, and the threads'
    16-byte chunks covering each tile exactly once."""
    plan = _ring_plan(es, gated)
    assert RING["MAX_SMEM"] == 232448
    assert plan["smem"] <= 232448 and 2 * (plan["smem"] + 1024) <= 228 * 1024
    assert 2 * (plan["nst"] - 1) * plan["stage"] >= 64 * 1024
    assert 4 * -(-4096 // RING["RING_CW"]) == 256 >= H100_SMS
    T, Cw, NT = RING["RING_T"], RING["RING_CW"], RING["RING_THREADS"]
    v = 16 // es
    cover = torch.zeros(T, Cw, dtype=torch.int32)
    for tid in range(NT):
        cc, t0 = (tid % plan["row_chunks"]) * v, tid // plan["row_chunks"]
        for j in range(plan["per"]):
            cover[t0 + j * plan["rstep"], cc:cc + v] += 1
    assert bool((cover == 1).all())
    assert Cw <= NT  # a scan thread a channel


def _buffer(B, S, width, dtype, offset=0):
    return torch.zeros(B, S, width + offset, dtype=dtype)[..., offset:]


#: (dtype, B, W, buffer width, base offset in elements) -> the route
ROUTE_CASES = {
    "fp32 W4096 contiguous": (torch.float32, 4, 4096, 4096, 0, "ring"),
    "bf16 W4096 contiguous": (torch.bfloat16, 4, 4096, 4096, 0, "ring"),
    "fp32 W100 (400-byte rows)": (torch.float32, 2, 100, 100, 0, "ring"),
    "bf16 W100 (200-byte rows)": (torch.bfloat16, 2, 100, 100, 0, "fwd"),
    "fp32 W129": (torch.float32, 1, 129, 129, 0, "fwd"),
    "bf16 W7": (torch.bfloat16, 3, 7, 7, 0, "fwd"),
    "fp32 W64 views of a wider buffer": (torch.float32, 2, 64, 128, 0, "ring"),
    "bf16 W64 seq stride off 16 bytes": (torch.bfloat16, 2, 64, 68, 0, "fwd"),
    "bf16 W64 base off 16 bytes": (torch.bfloat16, 2, 64, 64, 4, "fwd"),
    "fp32 W64 base 16 bytes in": (torch.float32, 2, 64, 64, 4, "ring"),
}


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route(case):
    dtype, B, W, width, offset, want = ROUTE_CASES[case]
    a = _buffer(B, 8, width, dtype, offset)[..., :W]
    b = _buffer(B, 8, width, dtype, offset)[..., :W]
    assert trg._route(a, b) == want
    # the gated entry takes the ring's alignment: its three streams route alike
    assert trg._route(a, b, _buffer(B, 8, width, dtype, offset)[..., :W]) == want


def test_route_ignores_the_stride_of_a_single_row():
    """A dim of extent 1 is never stepped: rows cut from a buffer whose batch
    stride (516 bf16, 1,032 bytes) is off 16 bytes take the ring when there
    is one row, and not when there are two."""
    buf = torch.zeros(3, 8 * 64 + 4, dtype=torch.bfloat16)[:, :8 * 64]
    a = buf.unflatten(1, (8, 64))
    assert a.stride(0) == 516
    assert trg._route(a[:1], a[:1]) == "ring"
    assert trg._route(a[:2], a[:2]) == "fwd"


def _emulate_ring(streams, h0, lab=None, *, drop_last_carry=False):
    """rglru_ring's walk in torch: a CTA a (row, RING_CW channels), tiles of
    RING_T steps staged zero-filled past S and W (the copies' zero fill),
    gated: a and b formed on the whole staged tile; then the scan of the
    tile's valid steps from the carried fp32 h, y staged in the output dtype
    and stored for valid steps and channels. ``drop_last_carry`` plants a
    fault: the last tile's scan starts from 0 instead of the carried h."""
    T, Cw = RING["RING_T"], RING["RING_CW"]
    Bsz, S, W = streams[0].shape
    dtype = streams[-1].dtype
    y = torch.full((Bsz, S, W), float("nan"), dtype=dtype)
    hout = torch.full((Bsz, W), float("nan"))
    for row in range(Bsz):
        for w0 in range(0, W, Cw):
            nw = min(Cw, W - w0)
            h = h0[row, w0:w0 + nw].float().clone()
            for t0 in range(0, S, T):
                n = min(T, S - t0)
                tile = [torch.zeros(T, Cw, dtype=dtype) for _ in streams]
                for st, src in zip(tile, streams):
                    st[:n, :nw] = src[row, t0:t0 + n, w0:w0 + nw]
                if lab is None:
                    a, b = (st.float() for st in tile)
                else:
                    lab_t = torch.zeros(Cw)
                    lab_t[:nw] = lab[w0:w0 + nw]
                    a, b = tref.rglru_decay_input(*tile, lab_t)
                    assert bool(torch.isfinite(a).all() and torch.isfinite(b).all())
                if drop_last_carry and t0 + T >= S:
                    h = torch.zeros_like(h)
                ys = torch.zeros(T, Cw, dtype=dtype)
                for t in range(n):
                    h = a[t, :nw] * h + b[t, :nw]
                    ys[t, :nw] = h.to(dtype)
                y[row, t0:t0 + n, w0:w0 + nw] = ys[:n, :nw]
            hout[row, w0:w0 + nw] = h
    return y, hout


#: the ring's edges: S off RING_T (and one step), W off RING_CW, one tile
EMULATION_CASES = {"B2 S45 W200": (2, 45, 200), "B1 S32 W64 one tile": (1, 32, 64),
                   "B3 S1 W8": (3, 1, 8), "B1 S70 W136": (1, 70, 136)}


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", EMULATION_CASES)
def test_ring_emulation_matches_the_recurrence(case, dtype):
    B, S, W = EMULATION_CASES[case]
    a, b, h0 = _torch(_inputs(len(case), B, S, W), dtype)
    err, ok = rglru_close(*_emulate_ring((a, b), h0), *tref.rglru_ref(a, b, h0), TOL[dtype])
    assert ok, err
    ins = _gated_inputs(len(case), B, S, W, dtype)
    r, i, x, lab, h0 = ins
    err, ok = rglru_close(*_emulate_ring((r, i, x), h0, lab), *tref.rglru_gated_ref(*ins),
                          TOL[dtype])
    assert ok, err


@pytest.mark.parametrize("gated", [False, True])
def test_ring_emulation_with_a_dropped_carry_fails(gated):
    """The planted fault of the card's phase 2 (the carry into the last tile
    dropped) put through the same check, at a shape with three step tiles:
    ``rglru_close`` must fail it."""
    B, S, W = 2, 3 * RING["RING_T"], 2 * RING["RING_CW"]
    if gated:
        r, i, x, lab, h0 = _gated_inputs(11, B, S, W, "bfloat16")
        want = tref.rglru_gated_ref(r, i, x, lab, h0)
        streams, tol = (r, i, x), TOL["bfloat16"]
    else:
        a, b, h0 = _torch(_inputs(11, B, S, W), "float32")
        want, streams, lab, tol = tref.rglru_ref(a, b, h0), (a, b), None, TOL["float32"]
    assert rglru_close(*_emulate_ring(streams, h0, lab), *want, tol)[1]
    err, ok = rglru_close(*_emulate_ring(streams, h0, lab, drop_last_carry=True), *want,
                          tol)
    assert not ok and err > 10 * tol


GPU_CASES = {
    **CASES, **RAGGED, **EMULATION_CASES,
    # recurrentgemma-9b's lru_width, one row
    "recurrentgemma-9b B1 S512 W4096": (1, 512, 4096),
}


def _routes(a, b):
    """Every route that can take a call: the one ``_route`` picks, then
    "fwd" forced where it picked "ring"."""
    main = trg._route(a, b)
    return [main] + (["fwd"] if main == "ring" else [])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = GPU_CASES[case]
    a, b, h0 = (t.cuda() for t in _torch(_inputs(len(case), *shape), dtype))
    # a and b as views of wider buffers: the kernel reads them through strides
    wide = torch.cat([a, b], dim=2)
    a, b = wide[..., :shape[2]], wide[..., shape[2]:]
    wy, wh = tref.rglru_ref(a, b, h0)
    for n, route in enumerate(_routes(a, b)):
        before = trg.rglru_scan.route_launches[f"scan {route}"]
        y, h = tops.rglru(a, b, h0) if n == 0 else trg.launch(a, b, h0, route)
        torch.cuda.synchronize()
        assert trg.rglru_scan.route_launches[f"scan {route}"] == before + 1
        # the kernel fuses a h + b into one FMA, the plain version rounds
        # twice: 1e-4 in fp32; bf16 y carries one bf16 rounding on each side
        tol = 1e-4 if dtype == "float32" else 2e-2
        torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(h, wh, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", {**EMULATION_CASES, **CASES,
                                  "recurrentgemma-9b B1 S512 W4096": (1, 512, 4096)})
def test_cuda_gated_entry_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shape = GPU_CASES[case]
    ins = tuple(t.cuda() for t in _gated_inputs(len(case), *shape, dtype))
    before = trg.rglru_scan.route_launches["gated ring"]
    y, h = tops.rglru_gated(*ins)
    torch.cuda.synchronize()
    assert trg.rglru_scan.route_launches["gated ring"] == before + 1
    err, ok = rglru_close(y, h, *tref.rglru_gated_ref(*ins), TOL[dtype])
    assert ok, err
