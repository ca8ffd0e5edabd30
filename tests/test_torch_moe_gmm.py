"""K3 parity: the port's moe_gmm_ref and ops.moe_gmm (the plain version on
the CPU) against the JAX Pallas kernel in interpret mode and the JAX
oracle, on the same numpy inputs; the routing point ``moe_gmm._route``; a
mirror of the TMA kernels' persistent tile walk (tile sizes read from
csrc/moe_gmm.cu) and a blockwise emulation of their arithmetic against
both; and, on a CUDA card, every kernel route against the plain version.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

# tests/test_kernels.py's tolerances: fp32 2e-5, bf16 2e-2 (one bf16
# rounding of outputs of magnitude ~1)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

CASES = {
    # tests/test_kernels.py:180-193, E x C x D x F
    "2x64x32x48": (2, 64, 32, 48),
    "4x100x64x96": (4, 100, 64, 96),
    "1x128x128x128": (1, 128, 128, 128),
    # deepseek-moe-16b smoke, B=2 rows of C=6: wg/wu and wd
    "deepseek smoke wg": (8, 12, 64, 32),
    "deepseek smoke wd": (8, 12, 32, 64),
    # nothing a multiple of a tile or of 8
    "ragged 3x5x37x19": (3, 5, 37, 19),
}


def _inputs(seed, E, C, D, F):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(E, C, D)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(E, D, F)) * 0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", CASES)
def test_plain_moe_gmm_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    x, w = _inputs(len(case), *CASES[case])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    want_kernel = jops.moe_gmm(jx, jw, interpret=True)
    want_ref = jref.moe_gmm_ref(jx, jw)
    got = tops.moe_gmm(tx, tw)
    assert got.dtype == tdt and got.shape == want_ref.shape
    tol = TOL[dtype]
    for t in (got, tref.moe_gmm_ref(tx, tw)):
        for want in (want_kernel, want_ref):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)


def test_strided_dispatch_view_matches_contiguous():
    # the model's dispatch buffer [E, B, C, d] viewed as [E, B*C, d], and a
    # row-strided view of it: the same products as contiguous copies
    x, w = _inputs(0, 4, 12, 16, 8)
    buf = torch.from_numpy(x).reshape(4, 2, 6, 16)
    for view in (buf.reshape(4, 12, 16), buf.reshape(4, 12, 16)[:, ::2]):
        got = tops.moe_gmm(view, torch.from_numpy(w))
        torch.testing.assert_close(got, tref.moe_gmm_ref(view.contiguous(),
                                                         torch.from_numpy(w)),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "device", "rank",
                                 "experts", "depth", "empty"])
def test_moe_gmm_rejects_what_the_kernel_cannot_take(bad):
    x, w = (torch.from_numpy(a) for a in _inputs(0, 2, 4, 8, 6))
    if bad == "dtype":
        x, w = x.half(), w.half()
    elif bad == "mixed_dtype":
        w = w.bfloat16()
    elif bad == "device":
        w = w.to("meta")
    elif bad == "rank":
        x = x[0]
    elif bad == "experts":
        w = w[:1]
    elif bad == "depth":
        w = w[:, :5]
    else:
        x = x[:, :0]
    with pytest.raises((TypeError, ValueError)):
        tops.moe_gmm(x, w)


def test_plain_calls_do_not_count_as_launches():
    before = tgmm.moe_gmm.launches
    tops.moe_gmm(*(torch.from_numpy(a) for a in _inputs(0, 2, 4, 8, 6)))
    assert tgmm.moe_gmm.launches == before


# --------------------------------------------------------------------------- #
# the TMA kernels' plan (csrc/moe_gmm.cu), mirrored on the CPU
# --------------------------------------------------------------------------- #
# their tile sizes, constants of the source, which the mirror shares with it
_BM, _BN, _WIDE_BM, _WIDE_BN, _BK, _DEC_ROWS, _DEC_BN, _DEC_BK = (
    build.cu_constant("moe_gmm", c)
    for c in ("TMA_BM", "TMA_BN", "WIDE_BM", "WIDE_BN", "TMA_BK", "DEC_ROWS", "DEC_BN",
              "DEC_BK"))
H100_SMS = 132

# deepseek-moe-16b's expert products on its main paths: prefill (B=4 rows
# of capacity 241) and served decode (4 slots of capacity 4), gate/up and
# down
PATH_SHAPES = {
    "prefill wg": (64, 964, 2048, 1408),
    "prefill wd": (64, 964, 1408, 2048),
    "decode wg": (64, 16, 2048, 1408),
    "decode wd": (64, 16, 1408, 2048),
}


def _smoke_gmm_cases() -> dict:
    """chip_smoke.py's K3 cases (GMM_CASES), E x C x D x F by name."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: shape for name, *shape in mod.GMM_CASES}


PLAN_SHAPES = {**CASES, **PATH_SHAPES, **_smoke_gmm_cases()}


def _padded(C, F, bm, bn):
    return -(-C // bm) * bm * (-(-F // bn) * bn)


def _prefill_tile(C, F):
    """The prefill kernel's tile (rows, columns): the wide one where it pads
    C and F to whole tiles with no more products than the tall one
    (csrc/moe_gmm.cu launch_tma)."""
    wide = _padded(C, F, _WIDE_BM, _WIDE_BN) <= _padded(C, F, _BM, _BN)
    return (_WIDE_BM, _WIDE_BN) if wide else (_BM, _BN)


def _tile_plan(route, E, C, D, F, sms):
    """A mirror of gmm_tma_wgmma's (route "tma") and gmm_decode_tma_wgmma's
    ("tma_decode") persistent walk: the tile (rows, columns, depth of a
    k-step), the k-steps of a tile, and for each CTA its tiles (expert, M
    tile, N tile) in order: tile t = (e, n, m), m fastest, CTA b taking
    t = b, b + grid, ... over min(sms, tiles) CTAs."""
    bm, bn, bk = ((*_prefill_tile(C, F), _BK) if route == "tma"
                  else (_DEC_ROWS, _DEC_BN, _DEC_BK))
    mt, nt = -(-C // bm), -(-F // bn)
    tiles = E * mt * nt
    grid = min(sms, tiles)

    def tile(t):
        e, r = divmod(t, mt * nt)
        n, m = divmod(r, mt)
        return e, m, n

    return (bm, bn, bk), -(-D // bk), [[tile(t) for t in range(b, tiles, grid)]
                                       for b in range(grid)]


def _plan_routes(C):
    return ("tma", "tma_decode") if C <= _DEC_ROWS else ("tma",)


@pytest.mark.parametrize("sms", [H100_SMS, 7])
@pytest.mark.parametrize("case,route", [(c, r) for c in PLAN_SHAPES
                                        for r in _plan_routes(PLAN_SHAPES[c][1])])
def test_tile_plan_covers_every_tile_once(case, route, sms):
    E, C, D, F = PLAN_SHAPES[case]
    (bm, bn, bk), kt, plan = _tile_plan(route, E, C, D, F, sms)
    mt, nt = -(-C // bm), -(-F // bn)
    walked = [t for cta in plan for t in cta]
    assert len(walked) == len(set(walked)) == E * mt * nt
    assert set(walked) == {(e, m, n) for e in range(E) for m in range(mt)
                           for n in range(nt)}
    # the CTAs split the tiles within one of each other, and the k-steps
    # cover D with less than one k-step of TMA's zeros
    assert max(map(len, plan)) - min(map(len, plan)) <= 1
    assert kt * bk >= D > (kt - 1) * bk
    # the M tiles sharing one expert's weight panel are walked side by side
    order = sorted((b + i * len(plan), t) for b, cta in enumerate(plan)
                   for i, t in enumerate(cta))
    for (_, (e0, m0, n0)), (_, (e1, m1, n1)) in zip(order, order[1:]):
        assert (e1, n1, m1) > (e0, n0, m0)
        if m1:
            assert (e1, n1, m1) == (e0, n0, m0 + 1)


def test_route_shares_the_decode_row_bound_with_the_kernel():
    assert tgmm.DECODE_ROWS == _DEC_ROWS


def test_tile_plan_fits_the_card():
    # the rings' shared memory and the prefill kernel's two 64-row output
    # stagings (csrc/moe_gmm.cu TMA_SMEM, DEC_SMEM) within the 232,448
    # bytes a block may use; the wide and tall tiles stage as many bytes a
    # k-step, and a stage holds both consumers' second output halves (64
    # rows by 128 columns each); the path shapes' tiles
    stages = {c: build.cu_constant("moe_gmm", c) for c in ("TMA_STAGES", "DEC_STAGES")}
    stage = (_BM + _BN) * _BK * 2
    assert (_WIDE_BM + _WIDE_BN) * _BK * 2 == stage
    out_half = 64 * 128 * 2
    assert 2 * out_half <= stage and stages["TMA_STAGES"] >= 3
    prefill = stages["TMA_STAGES"] * stage + 2 * out_half
    decode = stages["DEC_STAGES"] * (_DEC_BK + 2 * _DEC_ROWS) * 128
    assert 1024 + prefill + 16 * stages["TMA_STAGES"] <= 232448
    assert 1024 + decode + 16 * stages["DEC_STAGES"] <= 232448
    plans = {k: _tile_plan("tma" if k.startswith("prefill") else "tma_decode",
                           *PATH_SHAPES[k], H100_SMS) for k in PATH_SHAPES}
    assert {k: (tile[:2], sum(map(len, cta))) for k, (tile, _, cta) in plans.items()} == {
        "prefill wg": ((256, 128), 64 * 4 * 11), "prefill wd": ((128, 256), 64 * 8 * 8),
        "decode wg": ((16, 64), 64 * 22), "decode wd": ((16, 64), 64 * 32)}


@pytest.mark.parametrize("C,F,want", [
    (964, 1408, "tall"),   # gate/up: wide would pad F to 1536
    (964, 2048, "wide"),   # down: both pad C to 1024, F exact
    (300, 72, "tall"),     # wide pads C to 384 and F to 256
    (130, 512, "wide"),    # both pad C to 256
    (130, 504, "wide"),    # a tie: the wide tile
    (600, 128, "tall"),    # wide pads F to 256 rows' worth more
    (16, 1408, "wide"),    # 16 rows: the tall tile pads to 256
])
def test_prefill_tile_by_padding(C, F, want):
    assert _prefill_tile(C, F) == ((_WIDE_BM, _WIDE_BN) if want == "wide" else (_BM, _BN))


def _emulate(x, w, route, sms=H100_SMS):
    """The TMA kernels' arithmetic, blockwise on the CPU: each CTA's tiles
    in its order, operands zero-filled past C, D and F (TMA's zeros), one
    fp32 product a k-step summed in order (the decode kernel's as out^T =
    w^T x^T), rounded once to x's dtype and written as the prefill
    kernel's epilogue stores it: each consumer warpgroup's two 64 x 128
    halves (tall tile: its 128 rows, 64 at a time; wide tile: its 64 rows,
    128 columns at a time). Returns the output and how often each element
    was written."""
    E, C, D = x.shape
    F = w.shape[2]
    (bm, bn, bk), kt, plan = _tile_plan(route, E, C, D, F, sms)
    mt, nt = -(-C // bm), -(-F // bn)
    xp = torch.zeros(E, mt * bm, kt * bk)
    xp[:, :C, :D] = x.float()
    wp = torch.zeros(E, kt * bk, nt * bn)
    wp[:, :D, :F] = w.float()
    out = torch.zeros(E, mt * bm, nt * bn)
    hits = torch.zeros(E, mt * bm, nt * bn, dtype=torch.int64)
    for cta in plan:
        for e, m, n in cta:
            rows, cols = slice(m * bm, (m + 1) * bm), slice(n * bn, (n + 1) * bn)
            acc = torch.zeros(bm, bn)
            for ks in range(kt):
                a = xp[e, rows, ks * bk:(ks + 1) * bk]
                b = wp[e, ks * bk:(ks + 1) * bk, cols]
                acc += (b.T @ a.T).T if route == "tma_decode" else a @ b
            if route == "tma_decode":
                out[e, rows, cols] = acc
                hits[e, rows, cols] += 1
                continue
            for wg in range(2):
                for h in range(2):
                    if bn == _BN:  # tall: rows wg * 128 + h * 64, all columns
                        r0, c0 = wg * 128 + h * 64, 0
                    else:          # wide: rows wg * 64, columns h * 128
                        r0, c0 = wg * 64, h * 128
                    box = (slice(m * bm + r0, m * bm + r0 + 64),
                           slice(n * bn + c0, n * bn + c0 + 128))
                    out[(e, *box)] = acc[r0:r0 + 64, c0:c0 + 128]
                    hits[(e, *box)] += 1
    return out[:, :C, :F].to(x.dtype), hits[:, :C, :F]


EMULATED = {
    # ragged: nothing a multiple of a tile, a k-step or 8; a C tile edge
    "ragged 3x5x37x19": (3, 5, 37, 19),
    "ragged 3x40x40x24": (3, 40, 40, 24),
    # every edge of the prefill tiles: C past 256, D past 64, F past 128
    "prefill edges 3x300x72x136": (3, 300, 72, 136),
    # the wide tile's edges: C past 128, D past 64, F past 256
    "wide edges 3x130x72x504": (3, 130, 72, 504),
    # the decode tiles' edges: D past 128, F past 64, at 16 rows
    "decode edges 2x16x200x72": (2, 16, 200, 72),
    "deepseek smoke wg": CASES["deepseek smoke wg"],
}


@pytest.mark.parametrize("case,route", [(c, r) for c in EMULATED
                                        for r in _plan_routes(EMULATED[c][1])])
def test_blockwise_emulation_matches_ref_and_pallas(case, route):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    x, w = _inputs(len(case) + len(route), *EMULATED[case])
    tx, tw = (torch.from_numpy(a).bfloat16() for a in (x, w))
    got, hits = _emulate(tx, tw, route)
    assert bool((hits == 1).all())
    want_kernel = jops.moe_gmm(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16), interpret=True)
    tol = TOL["bfloat16"]
    for want in (tref.moe_gmm_ref(tx, tw).float().numpy(),
                 np.asarray(want_kernel, np.float32)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _meta(E, C, D, F, dtype=torch.bfloat16):
    """x and w of a full-width shape with no storage (base address 0)."""
    return (torch.empty(E, C, D, dtype=dtype, device="meta"),
            torch.empty(E, D, F, dtype=dtype, device="meta"))


@pytest.mark.parametrize("case,want", [
    ("prefill wg", "tma"), ("prefill wd", "tma"),
    ("decode wg", "tma_decode"), ("decode wd", "tma_decode"),
])
def test_route_on_the_main_paths(case, want):
    assert tgmm._route(*_meta(*PATH_SHAPES[case])) == want


def test_route_by_rows_alignment_and_dtype():
    # the row bound of the decode kernel
    assert tgmm._route(*_meta(64, _DEC_ROWS, 2048, 1408)) == "tma_decode"
    assert tgmm._route(*_meta(64, _DEC_ROWS + 1, 2048, 1408)) == "tma"
    assert tgmm._route(*_meta(64, 4, 2048, 1408)) == "tma_decode"
    # ragged D or F, the smoke configs' and the ragged cases: mma.sync
    for shape in (CASES["ragged 3x5x37x19"], (3, 40, 36, 24), (3, 40, 40, 20)):
        assert tgmm._route(*_meta(*shape)) == "mma"
    # the model's dispatch buffer and a row-strided view of it: TMA reads
    # through the strides
    buf = torch.zeros(4, 2, 24, 64, dtype=torch.bfloat16)
    w = torch.zeros(4, 64, 32, dtype=torch.bfloat16)
    assert tgmm._route(buf.reshape(4, 48, 64), w) == "tma"
    assert tgmm._route(buf.reshape(4, 48, 64)[:, ::2], w) == "tma"
    # a row stride off 16 bytes, and a base 2 bytes past 16-byte alignment
    assert tgmm._route(torch.zeros(4, 48, 68, dtype=torch.bfloat16)[..., :64], w) == "mma"
    flat = torch.zeros(1 + 4 * 48 * 64, dtype=torch.bfloat16)
    off = flat[1:].view(4, 48, 64)
    assert off.data_ptr() % 16 == 2
    assert tgmm._route(off, w) == "mma"
    # fp32: the CUDA cores, at any shape
    assert tgmm._route(*_meta(64, 964, 2048, 1408, torch.float32)) == "f32"
    assert tgmm._route(*_meta(*CASES["ragged 3x5x37x19"], torch.float32)) == "f32"


def test_launch_takes_cuda_tensors_of_its_route_only():
    x, w = (torch.from_numpy(a) for a in _inputs(0, 2, 4, 8, 8))
    with pytest.raises(ValueError, match="cuda"):
        tgmm.launch(x.bfloat16(), w.bfloat16(), "tma")
    before = (tgmm.moe_gmm.launches, dict(tgmm.moe_gmm.route_launches))
    tops.moe_gmm(x.bfloat16(), w.bfloat16())
    assert (tgmm.moe_gmm.launches, tgmm.moe_gmm.route_launches) == before


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
GPU_CASES = {
    **CASES,
    # deepseek-moe-16b full width: decode (B=4 as one group, C=4) and prefill
    # (B=4 rows of C=241), wg and wd
    "deepseek decode wg": (64, 4, 2048, 1408),
    "deepseek decode wd": (64, 4, 1408, 2048),
    "deepseek prefill wg": (64, 964, 2048, 1408),
    # the main paths' shapes (served decode: 4 slots of capacity 4)
    **{f"deepseek path {k}": v for k, v in PATH_SHAPES.items()},
    **{k: v for k, v in EMULATED.items() if k not in CASES},
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", TOL)
@pytest.mark.parametrize("case", GPU_CASES)
def test_cuda_kernel_matches_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(tdt).cuda()
            for a in _inputs(len(case), *GPU_CASES[case]))
    before = tgmm.moe_gmm.launches
    got = tops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert tgmm.moe_gmm.launches == before + 1
    want = tref.moe_gmm_ref(x, w).float()
    # the card sums in another order than the plain version: 1e-4 in fp32;
    # in bf16 one rounding of the output, 2e-2 plus 2e-2 relative
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def _card_routes(C, D, F):
    """The bf16 routes that can take contiguous x [E,C,D] and w [E,D,F]."""
    if D % 8 or F % 8:
        return ("mma",)
    return ("mma", "tma", "tma_decode") if C <= _DEC_ROWS else ("mma", "tma")


@pytest.mark.gpu
@pytest.mark.parametrize("case,route", [(c, r) for c in GPU_CASES
                                        for r in _card_routes(*GPU_CASES[c][1:])])
def test_cuda_each_route_matches_plain(case, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w = (torch.from_numpy(a).bfloat16().cuda()
            for a in _inputs(len(case), *GPU_CASES[case]))
    before = tgmm.moe_gmm.route_launches[route]
    got = tgmm.launch(x, w, route)
    torch.cuda.synchronize()
    assert tgmm.moe_gmm.route_launches[route] == before + 1
    want = tref.moe_gmm_ref(x, w).float()
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
