"""K1 parity: the port's flash_decode (plain version on the CPU) against the
JAX Pallas kernel in interpret mode and the JAX oracle, on the same numpy
inputs; the kernel's split plan and a torch model of its split-KV algebra
(partials per split, then the combine) against the plain version; and, on a
CUDA card, the hand-written kernel against the plain version.

JAX is imported inside the parity tests only, so that the card's tests
(``pytest -m gpu``) run where JAX is not installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# two intra-op threads at most: the timing-bound reference tests in the
# other pytest workers share this host's cores
torch.set_num_threads(min(2, torch.get_num_threads()))

DTYPES = ("float32", "bfloat16")
TOL32 = 2e-5  # bf16: _bf16_limit


def _bf16_limit(want):
    """The kernel's bf16 limit on |kernel - plain| (``chip_smoke.k1_limit``):
    one bf16 ulp of the output, 2^-7 |want|, plus 2^-8 of the largest
    |want| (at most 2e-2) for the fp32-level differences. It follows the
    outputs' scale, which at W = 2048 is ~0.04 and at W = 32768 ~0.009."""
    return 2.0 ** -7 * want.abs() + torch.clamp(2.0 ** -8 * want.abs().amax(),
                                                max=2e-2)


def _inputs(seed, B, H, KV, W, D, q_pos, masked_rows=()):
    """Model-layout caches [B,W,KV,D]; slot w holds the newest position
    p <= q_pos[b] with p % W == w (-1 if none), so q_pos >= W wraps."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, W, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, W, KV, D)).astype(np.float32)
    qp = np.asarray(q_pos, np.int32)
    p = qp[:, None].astype(np.int64) - np.mod(qp[:, None] - np.arange(W), W)
    cpos = np.where(p >= 0, p, -1).astype(np.int32)
    cpos[list(masked_rows)] = -1
    return q, k, v, cpos, qp


CASES = {
    # name: (B, H, KV, W, D, q_pos, window, masked rows)
    "test_kernels-a g1": (1, 4, 4, 64, 32, [37], None, ()),
    "test_kernels-a g2 w48": (1, 4, 2, 64, 32, [60], 48, ()),
    "test_kernels-b g2 w48": (2, 8, 4, 128, 16, [5, 60], 48, ()),
    "test_kernels-b g1": (2, 8, 8, 128, 16, [20, 127], None, ()),
    "smollm smoke heads": (2, 3, 1, 32, 20, [10, 31], None, ()),
    "smollm full heads": (2, 15, 5, 96, 64, [0, 95], None, ()),
    "ring wrap window 48": (3, 15, 5, 48, 64, [47, 100, 1000], 48, ()),
    "fully masked row": (2, 3, 1, 40, 20, [5, 30], None, (0,)),
    # recurrentgemma-9b's local attention heads (MQA, G=16, D=256) on a
    # ring that wraps, with its window
    "recurrentgemma D256 G16 ring window 64": (2, 16, 1, 64, 256, [63, 200], 64, ()),
    # the edges of the kernel's split of W (64-slot tiles, several splits
    # from W = 128 up on 132 SMs): W not a multiple of a split; a window
    # that ends inside a split, with most splits wholly out of it; splits
    # wholly empty beside valid ones; a fully masked row at W = 2048
    "W200 ragged last split": (2, 8, 2, 200, 64, [199, 150], None, ()),
    "W2048 window 100 inside a split": (2, 6, 2, 2048, 64, [1999, 3000], 100, ()),
    "W2048 empty splits beside valid": (2, 6, 2, 2048, 32, [70, 2047], None, ()),
    "W2048 fully masked row": (2, 6, 3, 2048, 64, [5, 1500], None, (0,)),
    "recurrentgemma G16 D256 W2048 window 2048": (1, 16, 1, 2048, 256, [3000], 2048, ()),
    "qwen2-vl G7 D128": (2, 14, 2, 300, 128, [299, 100], None, ()),
    "danube G4 D120 window 200": (2, 8, 2, 300, 120, [299, 250], 200, ()),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_flash_decode_matches_jax(case, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    B, H, KV, W, D, q_pos, window, masked = CASES[case]
    q, k, v, cpos, qp = _inputs(len(case), B, H, KV, W, D, q_pos, masked)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    want_kernel = jops.flash_decode(jq, jk, jv, jnp.asarray(cpos), jnp.asarray(qp),
                                    window=window, interpret=True)
    want_ref = jref.flash_decode_ref(jq, jnp.swapaxes(jk, 1, 2),
                                     jnp.swapaxes(jv, 1, 2), jnp.asarray(cpos),
                                     jnp.asarray(qp), window=window)
    got = tops.flash_decode(tq, tk, tv, torch.from_numpy(cpos),
                            torch.from_numpy(qp), window=window)
    assert got.dtype == tdt and got.shape == (B, H, D)
    for want in (want_kernel, want_ref):
        want = torch.from_numpy(np.asarray(want, np.float32))
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=TOL32, atol=TOL32)
        else:
            assert bool(((got.float() - want).abs() <= _bf16_limit(want)).all())
    for b in masked:
        assert bool((got[b] == 0).all())


def test_kernel_layout_entry_matches_model_layout():
    q, k, v, cpos, qp = _inputs(0, 2, 6, 2, 50, 16, [49, 20])
    t = [torch.from_numpy(a) for a in (q, k, v, cpos, qp)]
    model = tops.flash_decode(*t, window=32)
    kernel = tdec.flash_decode(t[0], t[1].transpose(1, 2).contiguous(),
                               t[2].transpose(1, 2).contiguous(), t[3], t[4],
                               window=32)
    torch.testing.assert_close(model, kernel, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "pos_dtype", "shape", "group",
                                 "window"])
def test_flash_decode_rejects_what_the_kernel_cannot_take(bad):
    q, k, v, cpos, qp = (torch.from_numpy(a) for a in
                         _inputs(0, 1, 4, 2, 16, 8, [5]))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "pos_dtype":
        cpos = cpos.long()
    elif bad == "shape":
        cpos = cpos[:, :8]
    elif bad == "group":
        q = torch.zeros(1, 3, 8)
    else:
        kw["window"] = -1
    with pytest.raises((TypeError, ValueError)):
        tops.flash_decode(q, k, v, cpos, qp, **kw)


def test_plain_calls_do_not_count_as_launches():
    before = tdec.flash_decode.launches
    t = [torch.from_numpy(a) for a in _inputs(0, 1, 3, 1, 8, 20, [3])]
    tops.flash_decode(*t)
    assert tdec.flash_decode.launches == before


@pytest.mark.parametrize("B, KV, G, W", [
    (4, 5, 3, 32768), (4, 5, 3, 512), (4, 1, 16, 2048), (4, 1, 16, 128),
    (1, 4, 1, 64), (2, 2, 7, 200), (1, 1, 40, 5000), (64, 8, 8, 4096),
    (1, 1, 1, 1), (3, 1, 1, 10 ** 6), (1, 1, 1, 10000)])
@pytest.mark.parametrize("slots", [396, 132, 1])
def test_split_plan_fills_one_wave_in_whole_tiles(B, KV, G, W, slots):
    nsplit, split_len = tdec._plan(B, KV, G, W, slots)
    assert split_len % tdec._TILE == 0 and 1 <= nsplit <= tdec._MAX_SPLITS
    assert (nsplit - 1) * split_len < W <= nsplit * split_len  # no empty split
    ctas = B * KV * -(-G // tdec._GROUP)
    tiles = -(-W // tdec._TILE)
    # one wave of the card's CTA slots at most, once W is split at all ...
    assert nsplit == 1 or ctas * nsplit <= slots
    # ... and at least half of what that wave, the tiles and the limit allow
    assert 2 * nsplit >= min(max(1, slots // ctas), tiles, tdec._MAX_SPLITS)


def _split_model(q, k, v, cpos, qp, window, split_len):
    """The kernel's algebra in torch: each split's (m, l, unnormalised acc)
    with m = -1e30 and l = acc = 0 where the split has no valid slot, then
    the combine. Caches in model layout."""
    B, H, D = q.shape
    W, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = torch.einsum("bkgd,bwkd->bkgw", q.reshape(B, KV, G, D).double() * D ** -0.5,
                     k.double())
    valid = (cpos >= 0) & (cpos <= qp[:, None])
    if window is not None:
        valid &= qp[:, None] - cpos < window
    valid = valid[:, None, None, :]
    ms, ls, accs = [], [], []
    for lo in range(0, W, split_len):
        sv, vv = s[..., lo:lo + split_len], valid[..., lo:lo + split_len]
        m = torch.where(vv, sv, tref.NEG).amax(-1, keepdim=True)
        p = torch.where(vv, torch.exp(sv - m), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bkgw,bwkd->bkgd", p, v[:, lo:lo + split_len].double()))
    m = torch.stack(ms)
    M = m.amax(0)
    w = torch.exp(m - M)  # 0 beside a valid split; 1 where every split is empty
    acc = (w * torch.stack(accs)).sum(0)
    l = (w * torch.stack(ls)).sum(0)
    return (acc / l.clamp_min(1e-30)).reshape(B, H, D)


@pytest.mark.parametrize("split", ["planned", "one tile"])
@pytest.mark.parametrize("case", CASES)
def test_split_kv_algebra_matches_plain(case, split):
    B, H, KV, W, D, q_pos, window, masked = CASES[case]
    t = [torch.from_numpy(a) for a in _inputs(len(case), B, H, KV, W, D, q_pos, masked)]
    split_len = (tdec._plan(B, KV, H // KV, W, 396)[1] if split == "planned"
                 else tdec._TILE)
    got = _split_model(*t, window, split_len)
    want = tref.flash_decode_ref(t[0], t[1].transpose(1, 2), t[2].transpose(1, 2),
                                 t[3], t[4], window=window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want, rtol=2e-5, atol=2e-5)
    for b in masked:
        assert bool((got[b] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["model", "kernel"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(case, dtype, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, H, KV, W, D, q_pos, window, masked = CASES[case]
    q, k, v, cpos, qp = _inputs(len(case), B, H, KV, W, D, q_pos, masked)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt).cuda() for a in (q, k, v)]
    t += [torch.from_numpy(cpos).cuda(), torch.from_numpy(qp).cuda()]
    before = tdec.flash_decode.launches
    if layout == "model":  # [B,W,KV,D] read through its strides
        got = tops.flash_decode(*t, window=window)
    else:  # [B,KV,W,D] contiguous
        got = tdec.flash_decode(t[0], t[1].transpose(1, 2).contiguous(),
                                t[2].transpose(1, 2).contiguous(), t[3], t[4],
                                window=window)
    torch.cuda.synchronize()
    assert tdec.flash_decode.launches == before + 1
    want = tref.flash_decode_ref(t[0], t[1].transpose(1, 2), t[2].transpose(1, 2),
                                 t[3], t[4], window=window)
    # the card sums in another order than the plain version: 1e-4 in fp32
    if dtype == "float32":
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-4, atol=1e-4)
    else:
        assert bool(((got.float() - want.float()).abs()
                     <= _bf16_limit(want.float())).all())
    for b in masked:
        assert bool((got[b] == 0).all())


@pytest.mark.parametrize("B, H, KV, W, D, q_pos, window", [
    (1, 15, 5, 32768, 64, [32767], None),                 # the long row
    (4, 16, 1, 2048, 256, [2047, 2048, 3000, 6000], 2048),  # recurrentgemma ring
])
def test_bf16_limit_resolves_a_dropped_split(B, H, KV, W, D, q_pos, window):
    """The bf16 limit is tight enough to fail a kernel that drops its last
    split: the plain version with that split's slots masked stands in for
    such a kernel."""
    q, k, v, cpos, qp = (torch.from_numpy(a) for a in
                         _inputs(W, B, H, KV, W, D, q_pos))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    nsplit, split_len = tdec._plan(B, KV, H // KV, W, 396)
    assert nsplit > 1
    want = tops.flash_decode(q, k, v, cpos, qp, window=window).float()
    dropped = cpos.clone()
    dropped[:, (nsplit - 1) * split_len:] = -1
    got = tops.flash_decode(q, k, v, dropped, qp, window=window).float()
    assert bool(((got - want).abs() > _bf16_limit(want)).any())
