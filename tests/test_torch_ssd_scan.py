"""K4 parity: the port's ssd_ref and ops.ssd_scan (the plain version on
the CPU), and the model's ssd_chunked, against the JAX Pallas kernel in
interpret mode and the JAX oracle, on the same numpy inputs; the routing
point ``ssd_scan._route``; route tc's shared-memory plan (sizes read from
csrc/ssd_scan.cu) and an emulation of its three kernels' arithmetic, in
their order, against both; and, on a CUDA card, every route against both
plain versions.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.mamba2 import ssd_chunked

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

# tests/test_kernels.py's tolerances: the SSD scan 1e-4 in fp32; bf16 x, B
# and C (dt and A stay fp32, as in the model) 2e-2
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

CASES = {
    # tests/test_kernels.py:112-152: (B, S, H, P, N), chunk
    "B1 S64 H2 P16 N8 Q16": (1, 64, 2, 16, 8, 16),
    "B1 S64 H2 P16 N8 Q32": (1, 64, 2, 16, 8, 32),
    "B2 S128 H4 P32 N16 Q16": (2, 128, 4, 32, 16, 16),
    "B2 S128 H4 P32 N16 Q32": (2, 128, 4, 32, 16, 32),
    # mamba2-2.7b smoke: d_inner 128 in heads of 16, state 16, chunk 16
    "mamba2 smoke B2 S48 H8 P16 N16 Q16": (2, 48, 8, 16, 16, 16),
    # a chunk that is not a multiple of the kernel's 32-step tile
    "Q20 B1 S60 H3 P8 N12": (1, 60, 3, 8, 12, 20),
}
# route tc's edges: H off both head groups (20 heads an output CTA, 10 a
# state CTA), a chunk that is not a multiple of the 16-row blocks, one
# chunk (no state carried)
EDGE_CASES = {
    "H21 off the head groups B1 S128 H21 P32 N32 Q64": (1, 128, 21, 32, 32, 64),
    "ragged Q100 B1 S200 H4 P32 N48": (1, 200, 4, 32, 48, 100),
    "nc=1 B2 S64 H3 P16 N16 Q64": (2, 64, 3, 16, 16, 64),
}


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_ssd", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: K4's criterion on the card (chip_smoke.ssd_close), for the emulation too
ssd_close = _chip_smoke().ssd_close


def _inputs(seed, B, S, H, P, N):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _cast(arrays, lib, dtype):
    """x, B and C in ``dtype``; dt and A fp32."""
    x, dt, A, Bm, Cm = arrays
    if lib == "jax":
        import jax.numpy as jnp
        f, low = jnp.asarray, getattr(jnp, dtype)
        return f(x).astype(low), f(dt), f(A), f(Bm).astype(low), f(Cm).astype(low)
    low = getattr(torch, dtype)
    f = torch.from_numpy
    return f(x).to(low), f(dt), f(A), f(Bm).to(low), f(Cm).to(low)


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_ssd_scan_matches_jax(case, dtype):
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    *dims, Q = CASES[case]
    arrays = _inputs(len(case), *dims)
    jin, tin = _cast(arrays, "jax", dtype), _cast(arrays, "torch", dtype)
    want = {"kernel": jops.ssd_scan(*jin, chunk=Q, interpret=True),
            "oracle": jref.ssd_ref(*jin)}
    got = {"ops": tops.ssd_scan(*tin, chunk=Q), "ref": tref.ssd_ref(*tin),
           "chunked": ssd_chunked(*tin, Q)}
    tol = TOL[dtype]
    for name, (y, h) in got.items():
        assert y.dtype == tin[0].dtype and h.dtype == torch.float32, name
        for wy, wh in want.values():
            np.testing.assert_allclose(y.float().numpy(), np.asarray(wy, np.float32),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(h.numpy(), np.asarray(wh, np.float32),
                                       rtol=tol, atol=tol)


def test_chunked_scan_matches_the_recurrence_at_any_chunk():
    tin = _cast(_inputs(3, 2, 64, 3, 8, 4), "torch", "float32")
    y_ref, h_ref = tref.ssd_ref(*tin)
    for Q in (1, 8, 64, 1000):  # 1000 > S: one chunk of S
        y, h = ssd_chunked(*tin, Q)
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h, h_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["x_dtype", "mixed_dtype", "dt_dtype",
                                 "device", "shape", "heads", "chunk"])
def test_ssd_scan_rejects_what_the_kernel_cannot_take(bad):
    x, dt, A, Bm, Cm = _cast(_inputs(0, 1, 32, 2, 4, 4), "torch", "float32")
    chunk = 16
    if bad == "x_dtype":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif bad == "mixed_dtype":
        Bm = Bm.bfloat16()
    elif bad == "dt_dtype":
        dt = dt.bfloat16()
    elif bad == "device":
        Cm = Cm.to("meta")
    elif bad == "shape":
        Bm = Bm[:, :16]
    elif bad == "heads":
        A = A[:1]
    else:
        chunk = 12  # 32 % 12 != 0
    with pytest.raises((TypeError, ValueError)):
        tops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def test_plain_calls_do_not_count_as_launches():
    before = tssd.ssd_scan.launches
    tops.ssd_scan(*_cast(_inputs(0, 1, 16, 2, 4, 4), "torch", "float32"), chunk=8)
    assert tssd.ssd_scan.launches == before


def _tc(name: str) -> int:
    return build.cu_constant("ssd_scan", name)


def test_route_limits_match_the_source():
    assert (tssd.TC_MAX_P, tssd.TC_MAX_N, tssd.TC_MAX_Q) == (
        _tc("TC_PM"), _tc("TC_NM"), _tc("TC_QM"))


def test_tc_plan_fits_the_card():
    # csrc/ssd_scan.cu's TC_STATE_SMEM and TC_OUT_SMEM at the largest P, N
    # and Q, within the 232,448 bytes a block may use; two state CTAs an SM
    # (228 KB, 1 KB reserved a block); the output CTA's causal triangle of
    # C B^T (1 KB a 16 x 16 block) beside one head's staging, with C staged
    # in the triangle's space and B in the head's before C B^T is formed
    PM, NM, QM, RB = _tc("TC_PM"), _tc("TC_NM"), _tc("TC_QM"), _tc("TC_RB")
    ldb, ldx = NM + 8, PM + 8
    state = QM * ldb * 2 + QM * ldx * 2 + 2 * QM * 4
    tri = RB * (RB + 1) // 2 * 1024
    head = QM * ldx * 2 + 2 * PM * ldb * 2 + 2 * QM * 4
    assert state <= 232448 and 2 * (state + 1024) <= 233472
    assert tri + head <= 232448
    assert QM * ldb * 2 <= min(tri, head)
    # 16-byte rows for cp.async and ldmatrix; 8 warps of two row blocks
    assert ldb * 2 % 16 == 0 and ldx * 2 % 16 == 0 and RB * 16 == QM and RB == 2 * 8
    assert (state, tri + head) == (108544, 212992)


def _meta(B, S, H, P, N, dtype=torch.bfloat16):
    """x, B and C with no storage (base address 0)."""
    return (torch.empty(B, S, H, P, dtype=dtype, device="meta"),
            torch.empty(B, S, N, dtype=dtype, device="meta"),
            torch.empty(B, S, N, dtype=dtype, device="meta"))


@pytest.mark.parametrize("case,want", [
    ("mamba2-2.7b", "tc"),
    ("fp32", "fwd"),
    ("P 8", "fwd"), ("N 12", "fwd"), ("P 80", "fwd"), ("N 144", "fwd"),
    ("chunk 512", "fwd"), ("chunk 512, S 256", "tc"),
    ("x base off 16 bytes", "fwd"), ("C row stride off 8", "fwd"),
    ("x head stride 2P view", "tc"), ("B and C views of one [B,S,2N]", "tc"),
])
def test_route(case, want):
    x, Bm, Cm = _meta(4, 2048, 80, 64, 128)
    chunk = 256
    if case == "fp32":
        x, Bm, Cm = _meta(4, 2048, 80, 64, 128, torch.float32)
    elif case.startswith("P "):
        x = _meta(4, 2048, 80, int(case[2:]), 128)[0]
    elif case.startswith("N "):
        _, Bm, Cm = _meta(4, 2048, 80, 64, int(case[2:]))
    elif case == "chunk 512":
        chunk = 512
    elif case == "chunk 512, S 256":
        x, Bm, Cm = _meta(1, 256, 8, 64, 128)
        chunk = 512  # the chunk is the whole sequence, 256 steps
    elif case == "x base off 16 bytes":
        x = torch.empty(2, 32, 4, 72, dtype=torch.bfloat16)[..., 1:65]
        Bm = Cm = torch.empty(2, 32, 128, dtype=torch.bfloat16)
    elif case == "C row stride off 8":
        Cm = torch.empty(4, 2048, 132, dtype=torch.bfloat16, device="meta")[..., :128]
    elif case == "x head stride 2P view":
        x = torch.empty(4, 2048, 80, 128, dtype=torch.bfloat16, device="meta")[..., :64]
    elif case == "B and C views of one [B,S,2N]":
        bc = torch.empty(4, 2048, 256, dtype=torch.bfloat16, device="meta")
        Bm, Cm = bc[..., :128], bc[..., 128:]
    assert tssd._route(x, Bm, Cm, chunk) == want


def _split(v):
    """An fp32 operand as the kernels feed it to the tensor cores: hi + lo
    bf16 terms, each widened back to fp32."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _decay(d):
    return torch.exp(torch.clamp(d, -60.0, 0.0))


def _emulate(x, dt, A, Bm, Cm, chunk, group, tile, sgroup, *, drop_carry=False):
    """Route tc's arithmetic on the CPU, kernel by kernel in their order,
    x, B and C bf16 and every sum in fp32: (a) per (head group of
    ``sgroup``, chunk, row), heads in turn, cum = cumsum(dt A) and the
    chunk's local state (x o w)^T B with x o w as hi + lo terms; (b) the
    state pass over the chunks, h_in[c] the state before chunk c
    (``drop_carry``: the last chunk's h_in left 0, a planted fault); (c)
    per (query tile of ``tile`` rows, head group of ``group``, chunk, row)
    C B^T once for the tile, then per head exp(clip(cum_i)) C_i h_in^T with
    h_in as hi + lo terms, plus the masked scores CB o decay o dt_j as hi +
    lo terms times x."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    st = torch.empty(Bsz, nc, H, P, N)
    cum = torch.empty(Bsz, nc, H, Q)
    for b in range(Bsz):
        for c in range(nc):
            rows = slice(c * Q, (c + 1) * Q)
            for h0 in range(0, H, sgroup):
                for h in range(h0, min(h0 + sgroup, H)):
                    cu = torch.cumsum(dt[b, rows, h] * A[h], 0)
                    cum[b, c, h] = cu
                    hi, lo = _split(xf[b, rows, h] * (_decay(cu[-1] - cu)
                                                      * dt[b, rows, h])[:, None])
                    st[b, c, h] = hi.T @ Bf[b, rows] + lo.T @ Bf[b, rows]
    h_in = torch.zeros_like(st)
    hc = torch.zeros(Bsz, H, P, N)
    for c in range(nc):
        if not (drop_carry and c == nc - 1):
            h_in[:, c] = hc
        hc = _decay(cum[:, c, :, -1])[..., None, None] * hc + st[:, c]
    y = torch.empty(Bsz, S, H, P)
    for b in range(Bsz):
        for c in range(nc):
            s0 = c * Q
            for r0 in range(0, Q, tile):
                i = torch.arange(r0, min(r0 + tile, Q))
                kend = int(i[-1]) + 1
                j = torch.arange(kend)
                CB = Cf[b, s0 + i] @ Bf[b, s0:s0 + kend].T  # once for the group
                for h0 in range(0, H, group):
                    for h in range(h0, min(h0 + group, H)):
                        cu = cum[b, c, h]
                        s = torch.where(j[None, :] <= i[:, None],
                                        CB * _decay(cu[i, None] - cu[None, :kend])
                                        * dt[b, s0:s0 + kend, h][None, :], 0.0)
                        sh, sl = _split(s)
                        xk = xf[b, s0:s0 + kend, h]
                        yi = sh @ xk + sl @ xk
                        if c:
                            hh, hl = _split(h_in[b, c, h])
                            ci = Cf[b, s0 + i]
                            yi = _decay(cu[i])[:, None] * (ci @ hh.T + ci @ hl.T) + yi
                        y[b, s0 + i, h] = yi
    return y.to(x.dtype), hc


def _tc_shape():
    # an output CTA takes the whole chunk (TC_QM rows at most)
    return {"group": _tc("TC_GROUP"), "tile": _tc("TC_QM"), "sgroup": _tc("TC_SGROUP")}


@pytest.mark.parametrize("case", {**CASES, **EDGE_CASES})
def test_tc_emulation_matches_ref_and_pallas(case):
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    *dims, Q = {**CASES, **EDGE_CASES}[case]
    tin = _cast(_inputs(len(case) + 7, *dims), "torch", "bfloat16")
    y, h = _emulate(*tin, Q, **_tc_shape())
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    # the plain versions on the same bf16 values widened to fp32, as on the
    # card (chip_smoke.fp32_ssd): they sum in fp32 and do not round y
    x, dt, A, Bm, Cm = (t.float().numpy() for t in tin)
    jin = _cast((x, dt, A, Bm, Cm), "jax", "float32")
    for wy, wh in (jops.ssd_scan(*jin, chunk=Q, interpret=True), jref.ssd_ref(*jin),
                   tref.ssd_ref(*(t.float() for t in tin))):
        wy, wh = (torch.from_numpy(np.array(a, np.float32)) for a in (wy, wh))
        assert ssd_close(y, wy)[1] <= 1, ssd_close(y, wy)
        assert ssd_close(h, wh)[1] <= 1, ssd_close(h, wh)


@pytest.mark.parametrize("case", ["B2 S128 H4 P32 N16 Q32", "H21 off the head groups B1 S128 H21 P32 N32 Q64"])
def test_tc_emulation_with_a_dropped_carry_fails(case):
    # a planted fault: the state pass leaves the last chunk's h_in at 0, so
    # the last chunk's y lacks the carried state; ssd_close must see it
    *dims, Q = {**CASES, **EDGE_CASES}[case]
    tin = _cast(_inputs(len(case) + 7, *dims), "torch", "bfloat16")
    wy, wh = tref.ssd_ref(*(t.float() for t in tin))
    y, h = _emulate(*tin, Q, **_tc_shape())
    assert ssd_close(y, wy)[1] <= 1 and ssd_close(h, wh)[1] <= 1
    y, h = _emulate(*tin, Q, **_tc_shape(), drop_carry=True)
    assert ssd_close(y, wy)[1] > 1
    assert torch.equal(h, _emulate(*tin, Q, **_tc_shape())[1])  # the final state keeps it


GPU_CASES = {
    **CASES,
    **EDGE_CASES,
    # mamba2-2.7b at full width, one row: 80 heads of 64, state 128, chunk 256
    "mamba2-2.7b B1 S512 H80 P64 N128 Q256": (1, 512, 80, 64, 128, 256),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    *dims, Q = GPU_CASES[case]
    x, dt, A, Bm, Cm = (t.cuda() for t in _cast(_inputs(len(case), *dims),
                                                "torch", dtype))
    # every route that takes the call: the one _route picks, then "fwd"
    # forced where it picked "tc" ("fwd" takes any call, "tc" only its own)
    main = tssd._route(x, Bm, Cm, Q)
    routes = [main] + (["fwd"] if main == "tc" else [])
    # against both plain versions run in fp32 on the same inputs, by
    # chip_smoke.ssd_close: 1e-4 |want| + 1e-4 of the output's scale for the
    # sum order; in bf16 also 2^-8 |want| + 2e-2, one rounding of y to bf16
    wide = (x.float(), dt, A, Bm.float(), Cm.float())
    wants = (tref.ssd_ref(*wide), ssd_chunked(*wide, Q))
    for i, route in enumerate(routes):
        before, by_route = tssd.ssd_scan.launches, dict(tssd.ssd_scan.route_launches)
        y, h = (tops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q) if i == 0
                else tssd.launch(x, dt, A, Bm, Cm, Q, route))
        torch.cuda.synchronize()
        assert tssd.ssd_scan.launches == before + 1
        assert tssd.ssd_scan.route_launches[route] == by_route[route] + 1
        for wy, wh in wants:
            assert max(ssd_close(y, wy)[1], ssd_close(h, wh)[1]) <= 1, (route, ssd_close(y, wy),
                                                                    ssd_close(h, wh))
