"""The port's CUDA kernels against their plain twins, on the card.

Needs a CUDA device and nvcc; skips elsewhere. This file imports no JAX, so
it also runs where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""

import copy
import os

import numpy as np
import pytest
import torch

from vit_ocm_wmsegmentation_tpu_torch import build
from vit_ocm_wmsegmentation_tpu_torch import pipeline as pl
from vit_ocm_wmsegmentation_tpu_torch.models import vit
from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as fa
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as fm
from vit_ocm_wmsegmentation_tpu_torch.ops import ln_linear as lnl
from vit_ocm_wmsegmentation_tpu_torch.ops import probes
from vit_ocm_wmsegmentation_tpu_torch.ops import quant
from vit_ocm_wmsegmentation_tpu_torch.ops import threshold as th

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # max|kernel - plain| / max|plain|


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with pl.exact_matmuls():
        yield torch.device("cuda")


def test_launch_helper_refuses_another_card_than_the_current(cuda):
    """Every kernel launch asks build.stream_ptr for its stream; a tensor on
    another card than the current device is refused before anything runs
    there (the launchers set attributes on the current device)."""
    here = torch.cuda.current_device()
    assert build.stream_ptr(torch.device("cuda", here)) == torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="current CUDA device"):
        build.stream_ptr(torch.device("cuda", here + 1))


def _close(got, want, dtype):
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got.float()).all()
    assert err <= TOL[dtype] * float(want.float().abs().max()), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,d", [(6, 64), (2, 128)])
@pytest.mark.parametrize("b,rows,n", [(2, 130, 130), (3, 200, 129), (1, 64, 1), (1, 127, 127),
                                      (1, 128, 128), (2, 129, 31), (2, 129, 33), (1, 257, 63),
                                      (1, 256, 65), (2, 255, 97)])
def test_attention_kernel_matches_plain(cuda, dtype, b, rows, n, heads, d):
    """Flat layout, both head dims; around the f32 kernel's tiles too (128
    query rows a CTA; 64-key tiles at d = 64, 32-key tiles at d = 128)."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    qkv = torch.randn(b, rows, 3 * heads * d, generator=gen, device=cuda)
    qkv[..., : heads * d] *= d ** -0.5
    qkv = qkv.to(dtype)
    before = fa.attention_qkv.launches
    got = fa.attention_qkv(qkv, heads, n)
    assert fa.attention_qkv.launches == before + 1
    _close(got, fa.attention_qkv_plain(qkv, heads, n), dtype)


def _mlp_cases(dtype_rows_d):
    """(dtype, rows, D, H): the given cases at H = 4 D, then float32 around
    the f32 kernels' tiles (64 rows a CTA, 128 hidden units a chunk): rows 1,
    63, 64, 65, 127, 129 and 1100 at D = 192 and 384, H = 768, 1536 and 832
    (a multiple of 64, not of 128)."""
    cases = [(dt, rows, d, 4 * d) for dt in DTYPES for rows, d in dtype_rows_d]
    cases += [(torch.float32, rows, d, h) for d in (192, 384) for h in (768, 1536, 832)
              for rows in (1, 63, 64, 65, 127, 129, 1100)]
    return list(dict.fromkeys(cases))


def _mlp_bf16_training_cases():
    """(bfloat16, rows, D, H) around the training MLP's wgmma tiles (64-row
    warpgroups in 128-row CTAs, the weight kernel's 64-row slices, 32-unit
    chunks and 128-unit weight tiles), one tile past a wave of 132 (16897
    rows: the forward splits it four ways on an H100) and at the MIM step's
    36880 rows: both widths, H = 4 D and H a multiple of 32, not of 64 (800,
    1568)."""
    rows = (1, 63, 64, 65, 127, 128, 129, 257, 1100, 16897, 36880)
    return [(torch.bfloat16, r, d, h) for d in (192, 384) for h in (4 * d, 800 if d == 192 else 1568)
            for r in rows if r < 16897 or h == 4 * d]


def _mlp_inputs(dev, seed, dtype, rows, d, h):
    """x, do (rows, D), scale, bias (D), w1 (H, D), b1 (H), w2 (D, H), b2 (D)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std=1.0, mean=0.0: torch.randn(*s, generator=gen, device=dev) * std + mean  # noqa: E731
    x, do = r(rows, d).to(dtype), r(rows, d).to(dtype)
    w1, w2 = r(h, d, std=d ** -0.5).to(dtype), r(d, h, std=h ** -0.5).to(dtype)
    s, bb, b1, b2 = r(d, std=0.1, mean=1.0), r(d, std=0.1), r(h, std=0.1), r(d, std=0.1)
    return x, do, s, bb, w1, b1, w2, b2


@pytest.mark.parametrize("dtype,rows,d,h", _mlp_cases([(70, 384), (33, 192), (1, 384)]))
def test_mlp_kernels_match_plain(cuda, dtype, rows, d, h):
    """The inference forwards (lnout and plain) against their twins, bit-equal
    across two calls."""
    x, _, s, bb, w1, b1, w2, b2 = _mlp_inputs(cuda, rows + d + h, dtype, rows, d, h)
    args = (x, s, bb, w1, b1, w2, b2)
    ln2 = (b2 + 1.0, bb)
    out, z = fm.fused_mlp_block_lnout(*args, *ln2)
    pout, pz = fm.fused_mlp_block_lnout_plain(*args, *ln2)
    _close(out, pout, dtype)
    _close(z, pz, dtype)
    assert _bit_equal((out, z), fm.fused_mlp_block_lnout(*args, *ln2))
    out = fm.fused_mlp_block(*args)
    _close(out, fm.fused_mlp_block_plain(*args), dtype)
    assert _bit_equal((out,), (fm.fused_mlp_block(*args),))


@pytest.mark.parametrize("n,b,heads,d",
                         [(n, b, h, d) for n in (1, 63, 65, 130, 2305)
                          for b, h, d in ((2, 6, 64), (3, 2, 128))]
                         + [(72, 2, 6, 64), (73, 2, 6, 64), (2305, 8, 6, 64), (1, 1, 1, 64),
                            (2305, 62, 6, 64)])
def test_attention_wgmma_kernel_matches_plain(cuda, n, b, heads, d):
    """The bf16 flat layout's wgmma kernel (csrc/attention_qkv_wgmma.cu) at
    ragged n: one key, one past and one short of the 64-key tile and of the
    128-row CTA, the mosaic's 2305; B * heads above 1, rows = n (keys
    never masked inside the tensor) and rows = n + 7 (keys n .. n + 6
    masked). At head dim 64 a last tile of at most 8 keys takes its own
    products (n = 72 the last to, 73 the first not to); a batch of 8 and the
    streamed band's 62 tiles at the mosaic's 2305 rows, and one head of one
    key."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    for rows in (n, n + 7):
        qkv = torch.randn(b, rows, 3 * heads * d, generator=gen, device=cuda)
        qkv[..., : heads * d] *= d ** -0.5
        qkv = qkv.to(torch.bfloat16)
        assert fa.attention_qkv_route(qkv, heads, n) == "attention_qkv_wgmma.cu"
        before = fa.attention_qkv.launches
        got = fa.attention_qkv(qkv, heads, n)
        assert fa.attention_qkv.launches == before + 1
        _close(got, fa.attention_qkv_plain(qkv, heads, n), torch.bfloat16)


@pytest.mark.parametrize("d,h", [(384, 1536), (192, 768), (384, 1568), (192, 800)])
@pytest.mark.parametrize("rows", [1, 70, 127, 129, 1100, 132 * 128 * 2 + 5, 112945])
def test_mlp_wgmma_kernels_match_plain(cuda, rows, d, h):
    """The bf16 inference MLP's wgmma kernel (csrc/fused_mlp_serve_wgmma.cu),
    lnout and plain, at row counts around its 128-row tile (a last tile of 5
    rows past two waves of 132 CTAs, whose second warpgroup has no row) and
    at the mosaic's 112945, both widths, H = 4D and H a multiple of its
    32-unit chunk only; two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d + h)
    r = lambda *s, std=1.0, mean=0.0: torch.randn(*s, generator=gen, device=cuda) * std + mean  # noqa: E731
    dtype = torch.bfloat16
    x = r(rows, d, std=2.0, mean=0.5).to(dtype)
    w1, w2 = r(h, d, std=d ** -0.5).to(dtype), r(d, h, std=h ** -0.5).to(dtype)
    args = (x, r(d, std=0.1, mean=1.0), r(d, std=0.1), w1, r(h, std=0.1), w2, r(d, std=0.1))
    ln2 = (r(d, std=0.1, mean=1.0), r(d, std=0.1))
    assert fm.mlp_route(x, w1, w2) == "fused_mlp_serve_wgmma.cu"
    before = (fm.fused_mlp_block_lnout.launches, fm.fused_mlp_block.launches)
    out, z = fm.fused_mlp_block_lnout(*args, *ln2)
    pout, pz = fm.fused_mlp_block_lnout_plain(*args, *ln2)
    _close(out, pout, dtype)
    _close(z, pz, dtype)
    plain = fm.fused_mlp_block(*args)
    assert torch.equal(plain, out)  # the same kernel without the z epilogue
    assert _bit_equal((out, z), fm.fused_mlp_block_lnout(*args, *ln2))
    assert (fm.fused_mlp_block_lnout.launches, fm.fused_mlp_block.launches) == (
        before[0] + 2, before[1] + 1)


def _digests(dev):
    """SHA-256 of kernel outputs on numpy-seeded inputs: the f32 MLP training
    forwards, the bf16 training attention (wgmma, dispatched through
    attention_qkv.cu and attention_bwd.cu), the f32 LN-out MLP, the bf16
    inference attention and LN-out MLP (wgmma), and the saved-P attention
    forward in bf16 (which shares the backward's row statistics). The f32
    training and inference attention, the bf16 MLP training forwards and the
    f32 saved-P forward are drawn (their inputs keep the draws of the others
    in place) but neither computed nor kept. Last, LN -> qkv in bf16,
    forward and backward, and its f32 forward at the MIM step's rows; then
    the bf16 attention at head dim 64 at the mosaic's flat shape and folded
    with its lse."""
    import hashlib

    rng = np.random.default_rng(6)
    t = lambda *s, dtype=torch.bfloat16, std=1.0, mean=0.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * std + mean).astype(np.float32)).to(dev, dtype)
    out = {}

    def keep(name, tensors):
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out[name] = h.hexdigest()[:16]

    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v, do = (t(4, 130, 128, dtype=dtype) for _ in range(4))
        if tag == "bf16":
            o, lse = fa.flash_attention(q, k, v)
            keep(f"flash_attention[{tag}]", (o, lse))
            keep(f"flash_attention_bwd[{tag}]", fa.flash_attention_bwd(q, k, v, o, lse, do))
        d, h, rows = 384, 1536, 1100
        x = t(rows, d, dtype=dtype, std=2.0, mean=0.5)
        mlp = (t(d, dtype=torch.float32, std=0.1, mean=1.0), t(d, dtype=torch.float32, std=0.1),
               t(h, d, dtype=dtype, std=d ** -0.5), t(h, dtype=torch.float32, std=0.1),
               t(d, h, dtype=dtype, std=h ** -0.5), t(d, dtype=torch.float32, std=0.1))
        if tag == "f32":
            keep(f"fused_mlp_block_h1[{tag}]", fm.fused_mlp_block_h1(x, *mlp))
            keep(f"fused_mlp_block_gp[{tag}]", fm.fused_mlp_block_gp(x, *mlp))
    t(2, 130, 3 * 6 * 64, dtype=torch.float32)  # the f32 inference attention's draw
    keep("fused_mlp_block_lnout[f32]", fm.fused_mlp_block_lnout(
        x, *mlp, t(d, dtype=torch.float32, std=0.1, mean=1.0), t(d, dtype=torch.float32, std=0.1)))
    qkv = t(2, 130, 3 * 6 * 64, std=0.5)
    keep("attention_qkv[bf16]", (fa.attention_qkv(qkv, 6, 130), fa.attention_qkv(qkv, 6, 77)))
    x = t(rows, d, std=2.0, mean=0.5)
    mlp = (mlp[0], mlp[1], t(h, d, std=d ** -0.5), mlp[3], t(d, h, std=h ** -0.5), mlp[5])
    keep("fused_mlp_block_lnout[bf16]", fm.fused_mlp_block_lnout(
        x, *mlp, t(d, dtype=torch.float32, std=0.1, mean=1.0), t(d, dtype=torch.float32, std=0.1)))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v, do = (t(4, 130, 128, dtype=dtype) for _ in range(4))
        if tag == "bf16":
            keep(f"flash_attention_savep[{tag}]", fa.flash_attention_savep(q, k, v))
    k = 3 * d  # LN -> qkv in bf16, drawn after every other input
    x, dy, w = t(rows, d, std=2.0, mean=0.5), t(rows, k), t(k, d, std=d ** -0.5)
    ln = (t(d, dtype=torch.float32, std=0.1, mean=1.0), t(d, dtype=torch.float32, std=0.1))
    keep("ln_linear[bf16]", (lnl.ln_linear(x, *ln, w, t(k, dtype=torch.float32, std=0.1)),))
    keep("ln_linear_bwd[bf16]", lnl.ln_linear_bwd(x, dy, *ln, w))
    x = t(36880, d, dtype=torch.float32, std=2.0, mean=0.5)  # the MIM step's rows, f32
    w = t(k, d, dtype=torch.float32, std=d ** -0.5)
    keep("ln_linear[f32]", (lnl.ln_linear(x, *ln, w, t(k, dtype=torch.float32, std=0.1)),))
    # the bf16 attention at head dim 64 where each CTA of the persistent grid
    # walks many units: the mosaic's flat call, all keys and keys masked past
    # n, then the folded call with its lse at 48 heads of 2305 rows
    qkv = t(49, 2305, 3 * 6 * 64, std=0.5)
    keep("attention_qkv_mosaic[bf16]",
         (fa.attention_qkv(qkv, 6, 2305), fa.attention_qkv(qkv, 6, 2250)))
    q, k, v = (t(48, 2305, 64) for _ in range(3))
    keep("flash_attention_d64[bf16]", fa.flash_attention(q, k, v))
    torch.cuda.synchronize()
    return out


# _digests of builds from before (H100 80GB HBM3, torch 2.11.0+cu128, CUDA
# 12.9), each of the last build before a change to the sources the kernel
# is built or dispatched from: of the build before the bf16 inference
# kernels moved to the wgmma sources, for the MLP training forwards and the
# f32 LN-out MLP; of the build before the wgmma attention kernel took the
# training layout too, for the wgmma inference kernels; of the build before
# the f32 attention kernels were redesigned on register tiles and cp.async
# (b4ae6e4), for the bf16 training attention, which dispatches through
# their two sources, and the saved-P forward, which shares a source with
# the saved-P backward. Each must give the same bits. The saved-P
# backward's entries were dropped when its kernels were redesigned (bf16
# on wgmma, f32 on register tiles), which changed the order of its f32
# sums on purpose; test_savep_attention_kernels_match_plain holds it. The
# bf16 MLP training forwards' entries (h1, gp) were dropped when they moved
# from mma.sync to the wgmma kernel of the inference forward, which changed
# the order of their f32 sums on purpose; test_mlp_training_kernels_match_plain
# and test_mlp_gp_kernels_match_plain hold them. fused_mlp_block_lnout[bf16]
# reproducing shows that the inference instances of that edited source kept
# their bits. The f32 saved-P forward's entry was dropped when that kernel
# was redesigned on register tiles with one pass over the keys, which
# changed its P by an ulp or two on purpose;
# test_savep_f32_forward_matches_twin_at_tile_edges and
# test_savep_attention_kernels_match_plain hold it. The LN -> qkv entries are
# of the build before the f32 LN -> qkv kernels were redesigned on register
# tiles (d6b469f): the f32 forward's shows that the redesign sums each output
# in the old order (over D from 0, then the bias), its last wave split over
# columns included. ln_linear[bf16] reproduces across the move of the bf16
# forward from mma.sync to the wgmma kernel of ln_linear_wgmma.cu, which
# normalizes x with the same arithmetic and sums each output over D in
# 16-wide steps from 0, then the bias, as the mma.sync kernel did. The
# f32 backward's bits changed on purpose (another split count, the LN
# backward's sums over other lanes); test_ln_linear_kernels_match_plain holds
# it. ln_linear_bwd[bf16] was recorded again on the build that moved the
# bf16 LN -> qkv backward from mma.sync to the wgmma kernels of
# ln_linear_bwd_wgmma.cu, whose f32 sums run in another order on purpose
# (dxn and dW over 16-wide wgmma steps, the weight partials over other
# splits, ln_part by reduce_rows). flash_attention_savep[bf16] reproduces
# across the move of the bf16 saved-P forward from mma.sync to the wgmma
# kernel of attention_savep_wgmma.cu: at this shape the new kernel gives the
# old one's bits. attention_qkv_mosaic[bf16] and flash_attention_d64[bf16]
# are of the build before the head dim 64 wgmma attention took a last key
# tile of at most 8 keys alone (scores over those 8, one k-step of P V): the
# tile's other keys are masked, their P is 0, so the bits stay.
# fused_mlp_block_lnout[bf16] reproduces across the move of the bf16
# inference MLP to csrc/fused_mlp_serve_wgmma.cu, whose products, GELU and
# LayerNorms (rows normalized and written several at a time, each row's sums
# in warp_ln_stats' order) are the old instances' arithmetic.
RECORDED_DIGESTS = {
    "fused_mlp_block_h1[f32]": "be74e9f764b63ced", "fused_mlp_block_gp[f32]": "ae9f854e7b52ec51",
    "fused_mlp_block_lnout[f32]": "4e1b3394e6e209af",
    "attention_qkv[bf16]": "c4f9a35a81b9f958", "fused_mlp_block_lnout[bf16]": "a24e075aa7885564",
    "flash_attention[bf16]": "3703a3532406f758", "flash_attention_bwd[bf16]": "3c44288015fabea3",
    "flash_attention_savep[bf16]": "a5417dca59721aa5", "ln_linear[bf16]": "29adf4aba5a9fd62",
    "ln_linear_bwd[bf16]": "54c13a7204f0a705", "ln_linear[f32]": "bbc401ebaae4650c",
    "attention_qkv_mosaic[bf16]": "695fa6db6a774e0d", "flash_attention_d64[bf16]": "e04128ce28fe033b"}


def test_kernels_left_in_place_reproduce_their_recorded_outputs(cuda):
    assert _digests(cuda) == RECORDED_DIGESTS


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# lse stays f32, but in bf16 a one-ulp flip of a rounded P term moves the
# denominator by up to 2^-8 of that term
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


def _close_grad(got, want, dtype):
    """Relative to max|plain|, with a 1e-6 floor: with one key (n = 1) dq and
    dk are exactly 0 and the kernel's sums leave ~1e-7."""
    err = float((got.float() - want.float()).abs().max())
    assert torch.isfinite(got.float()).all()
    assert err <= GRAD_TOL[dtype] * float(want.float().abs().max()) + 1e-6, err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,n,d", [(4, 130, 128), (3, 129, 64), (2, 1, 64), (2, 64, 128),
                                    (2, 65, 128), (3, 127, 64), (2, 128, 128), (2, 192, 64),
                                    (3, 257, 128), (2, 257, 64), (48, 2305, 128), (2, 31, 128),
                                    (2, 32, 128), (2, 33, 128), (3, 63, 64), (2, 96, 128),
                                    (2, 97, 64), (2, 255, 64), (2, 256, 128), (1, 385, 128),
                                    (2, 65, 64), (18, 2305, 64)])
def test_flash_attention_kernels_match_plain(cuda, dtype, bh, n, d):
    """Around the tiles of the bf16 wgmma kernels (64 keys or queries a tile,
    128 queries or keys a CTA), of the f32 ones (forward and dq: 128 queries
    a CTA, key tiles of 64 at d = 64 and 32 at d = 128; dk/dv: 64 keys a
    CTA, query tiles of 64 at d = 64 and 32 at d = 128), at the MIM
    step's (48, 2305, 128) and the finetune step's (18, 2305, 64)."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    q, k, v, do = (torch.randn(bh, n, d, generator=gen, device=cuda).to(dtype) for _ in range(4))
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    out, lse = fa.flash_attention(q, k, v)
    pout, plse = fa.flash_attention_plain(q, k, v)
    _close(out, pout, dtype)
    err = float((lse - plse).abs().max())
    assert err <= LSE_TOL[dtype] * float(plse.abs().max()), err
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do)
    for g, w in zip(grads, fa.flash_attention_bwd_plain(q, k, v, out, lse, do)):
        _close_grad(g, w, dtype)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,n,d", [(3, 257, 128), (2, 129, 64), (48, 2305, 128)])
def test_flash_attention_kernels_are_deterministic(cuda, dtype, bh, n, d):
    """The training attention's kernels, forward and backward, f32 on the
    CUDA cores and bf16 on wgmma (dk, dv and dq each summed in a fixed
    order, no atomics): two calls on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(n + d + 5)
    q, k, v, do = (torch.randn(bh, n, d, generator=gen, device=cuda).to(dtype) for _ in range(4))
    bf16 = dtype == torch.bfloat16
    assert fa.flash_attention_route(q, k, v) == (
        "attention_qkv_wgmma.cu" if bf16 else "attention_qkv.cu")
    assert fa.flash_attention_bwd_route(q, k, v, q, do) == (
        "attention_bwd_wgmma.cu" if bf16 else "attention_bwd.cu")
    out, lse = fa.flash_attention(q, k, v)
    assert _bit_equal((out, lse), fa.flash_attention(q, k, v))
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do)
    assert _bit_equal(grads, fa.flash_attention_bwd(q, k, v, out, lse, do))


@pytest.mark.parametrize("dtype,rows,d,h",
                         list(dict.fromkeys(_mlp_cases([(70, 384), (130, 192), (1, 384), (1100, 384)])
                                            + _mlp_bf16_training_cases())))
def test_mlp_training_kernels_match_plain(cuda, dtype, rows, d, h):
    """The save-h1 forward and its backward against their twins, each
    bit-equal across two calls."""
    x, do, s, bb, w1, b1, w2, b2 = _mlp_inputs(cuda, rows + d + h + 1, dtype, rows, d, h)
    out, h1 = fm.fused_mlp_block_h1(x, s, bb, w1, b1, w2, b2)
    pout, ph1 = fm.fused_mlp_block_plain(x, s, bb, w1, b1, w2, b2, want_h1=True)
    _close(out, pout, dtype)
    _close(h1, ph1, dtype)
    assert _bit_equal((out, h1), fm.fused_mlp_block_h1(x, s, bb, w1, b1, w2, b2))
    grads = fm.fused_mlp_bwd(x, do, h1, s, bb, w1, w2)
    for g, w in zip(grads, fm.fused_mlp_bwd_plain(x, do, h1, s, bb, w1, w2)):
        _close_grad(g, w, dtype)
    assert _bit_equal(grads, fm.fused_mlp_bwd(x, do, h1, s, bb, w1, w2))


def test_wrappers_reject_layouts_they_do_not_take(cuda):
    x = torch.zeros(4, 384, device=cuda)
    v = torch.zeros(384, device=cuda)
    w1, w2 = torch.zeros(1536, 384, device=cuda), torch.zeros(384, 1536, device=cuda)
    b1 = torch.zeros(1536, device=cuda)
    with pytest.raises(ValueError, match="w1"):
        fm.fused_mlp_block(x, v, v, w2, b1, w1, v)  # swapped layouts
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_mlp_block(x, v, v, w1.T.contiguous().T, b1, w2, v)
    with pytest.raises(ValueError, match="must be contiguous"):
        fm.fused_mlp_block(x, v, v, w1.half(), b1, w2, v)
    with pytest.raises(ValueError, match="D in"):
        fm.fused_mlp_block(torch.zeros(4, 256, device=cuda), v, v, w1, b1, w2, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.attention_qkv(torch.zeros(1, 8, 3 * 2 * 32, device=cuda), 2, 8)
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="share"):
        fa.flash_attention(q, q, q.bfloat16())
    with pytest.raises(ValueError, match="h1"):
        fm.fused_mlp_bwd(x, x, x, v, v, w1, w2)


def test_vit_tiny_mosaic_kernel_route_matches_plain_route(cuda, monkeypatch):
    """f32 only: in bf16, routes that differ only in f32 summation order
    already give masks about 1 % apart on this noise input with random
    weights (Dice 0.987-0.991 at 192^2, H100), the same spread as bf16
    against f32; chip_smoke.py holds bf16 to its gates at 1152^2."""
    dtype = torch.float32
    model = vit.init(vit.VIT_TINY(patch_size=8), torch.Generator().manual_seed(0), cuda)
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((192, 192)) * 255).astype(np.uint8)).to(cuda)
    mask, attn = pl.segment_mosaic(model, img, 96, 32, dtype=dtype)
    monkeypatch.setattr(fa, "attention_qkv", fa.attention_qkv_plain)
    monkeypatch.setattr(fm, "fused_mlp_block", fm.fused_mlp_block_plain)
    monkeypatch.setattr(fm, "fused_mlp_block_lnout", fm.fused_mlp_block_lnout_plain)
    pmask, pattn = pl.segment_mosaic(model, img, 96, 32, dtype=dtype)
    a, b = mask.cpu().numpy() > 0, pmask.cpu().numpy() > 0
    assert 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1) >= 0.999
    assert float((attn - pattn).abs().max()) < 2e-3  # 0-255 scale


def _u8_case(case, dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    if case == "n0":
        return torch.empty(0, dtype=torch.uint8, device=dev)
    if case == "n1":
        return torch.full((1,), 200, dtype=torch.uint8, device=dev)
    if case == "17x13":
        return torch.randint(0, 256, (17, 13), generator=gen, device=dev, dtype=torch.uint8)
    if case == "misaligned":  # a view whose data pointer is 1 byte past a 16-byte boundary
        x = torch.randint(0, 256, (100003,), generator=gen, device=dev, dtype=torch.uint8)
        return x[1:]
    if case == "zeros_2^30":  # one bin, every lane of a warp on one shared address
        return torch.zeros(1 << 30, dtype=torch.uint8, device=dev)
    x = torch.full(((1 << 24) + 67,), 7, dtype=torch.uint8, device=dev)  # past f32's 2^24
    x[-5:] = 9
    return x


# the histogram kernel's pieces (16 KB) and its grid's stride over them (a
# piece each of 132 CTAs on an H100)
HIST_PIECE, HIST_STRIDE = 16384, 132 * 16384
HIST_CASES = (["n0", "n1", "17x13", "misaligned", "zeros_2^30", "2^24+67"]
              + [f"offset{o}" for o in range(1, 16)]
              + [f"len{n}" for n in (15, 16, 17, HIST_PIECE - 1, HIST_PIECE, HIST_PIECE + 1,
                                     HIST_PIECE + 16, HIST_STRIDE - 16, HIST_STRIDE,
                                     HIST_STRIDE + 17, 2 * HIST_STRIDE + HIST_PIECE + 5)]
              + ["skew_2^28"])


def _u8_more(case, dev):
    """HIST_CASES past _u8_case's: views o bytes past a 16-byte boundary over
    several pieces, lengths around a piece and the grid's stride, and 2^28
    bytes of ~90 % bin 0 with runs of zeros (a 2^24-byte block 16 times, so
    that every count is a multiple of 16 and the f32 counts are exact)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    if case.startswith("offset"):
        x = torch.randint(0, 256, (5 * HIST_PIECE + 101,), generator=gen, device=dev,
                          dtype=torch.uint8)
        return x[int(case[6:]):]
    if case.startswith("len"):
        return torch.randint(0, 256, (int(case[3:]),), generator=gen, device=dev,
                             dtype=torch.uint8)
    x = torch.randint(0, 256, (1 << 24,), generator=gen, device=dev, dtype=torch.uint8)
    keep = torch.randint(0, 10, (1 << 24,), generator=gen, device=dev, dtype=torch.uint8) == 0
    x = torch.where(keep, x, torch.zeros_like(x))
    x[: 1 << 20] = 0  # and a run of 1 MB of zeros
    return x.repeat(16)


@pytest.mark.parametrize("case", HIST_CASES)
def test_histogram_kernel_equals_twin(cuda, case):
    x = (_u8_more if case.startswith(("offset", "len", "skew")) else _u8_case)(case, cuda)
    if case == "misaligned":
        assert x.data_ptr() % 16 != 0
    if case.startswith("offset"):
        assert x.data_ptr() % 16 == int(case[6:])
    before = th.histogram_u8_kernel.launches
    got = th.histogram_u8_kernel(x)
    want = th.histogram_u8_chunked(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert float(got.double().sum()) == x.numel()
    assert th.histogram_u8_kernel.launches == before + (1 if x.numel() else 0)


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,n,d", [(4, 130, 128), (3, 129, 64), (2, 1, 64), (2, 64, 128),
                                    (2, 63, 64), (2, 65, 128), (3, 127, 128), (2, 127, 64),
                                    (2, 128, 64), (2, 129, 128), (2, 192, 128), (2, 255, 64),
                                    (3, 257, 128), (2, 257, 64), (1, 385, 128), (48, 2305, 128)])
def test_savep_attention_kernels_match_plain(cuda, dtype, bh, n, d):
    """The saved-P forward (out, P, inv) and backward against their twins;
    P's padded columns are 0; both are bit-equal across two runs. Around
    the forward's tiles (bf16: 128 queries a CTA, 64-key tiles; f32: 128
    queries a CTA, key tiles of 128 at d = 64 and 64 at d = 128), the
    backward's (bf16: 128 keys a dk/dv CTA in 64-query tiles, 128 queries a
    dq CTA in 64-key tiles; f32: 64 keys a dk/dv CTA in 64-query tiles, 128
    queries a dq CTA in key tiles of 64 at d = 64 and 32 at d = 128) and at
    the MIM step's (48, 2305, 128)."""
    gen = torch.Generator(device=cuda).manual_seed(n + d + 2)
    q, k, v, do = (torch.randn(bh, n, d, generator=gen, device=cuda).to(dtype) for _ in range(4))
    bf16 = dtype == torch.bfloat16
    assert fa.flash_attention_savep_route(q, k, v) == (
        "attention_savep_wgmma.cu" if bf16 else "attention_savep.cu")
    assert fa.flash_attention_bwd_savep_route(q, k, v, q, do) == (
        "attention_savep_bwd_wgmma.cu" if bf16 else "attention_savep.cu")
    before = (fa.flash_attention_savep.launches, fa.flash_attention_bwd_savep.launches)
    out, p, inv = fa.flash_attention_savep(q, k, v)
    assert _bit_equal((out, p, inv), fa.flash_attention_savep(q, k, v))
    pout, pp, pinv = fa.flash_attention_savep_plain(q, k, v)
    assert p.shape == pp.shape == (bh, n, fa.p_columns(n)) and p.dtype == dtype
    assert not p[..., n:].any()
    _close(out, pout, dtype)
    _close(p, pp, dtype)
    err = float((inv - pinv).abs().max())
    assert err <= LSE_TOL[dtype] * float(pinv.abs().max()), err
    grads = fa.flash_attention_bwd_savep(q, k, v, out, p, inv, do)
    for g, w in zip(grads, fa.flash_attention_bwd_savep_plain(q, k, v, out, p, inv, do)):
        _close_grad(g, w, dtype)
    assert _bit_equal(grads, fa.flash_attention_bwd_savep(q, k, v, out, p, inv, do))
    assert (fa.flash_attention_savep.launches, fa.flash_attention_bwd_savep.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("dtype,rows,d,h",
                         list(dict.fromkeys(_mlp_cases([(70, 384), (130, 192), (1, 384), (1100, 384)])
                                            + _mlp_bf16_training_cases())))
def test_mlp_gp_kernels_match_plain(cuda, dtype, rows, d, h):
    """The SAVE_GP forward against its twin, its out bit-equal to the h1
    forward's; the gp backward against its twin, bit-equal across two calls."""
    x, do, s, bb, w1, b1, w2, b2 = _mlp_inputs(cuda, rows + d + h + 3, dtype, rows, d, h)
    out, g, gp = fm.fused_mlp_block_gp(x, s, bb, w1, b1, w2, b2)
    pout, pg, pgp = fm.fused_mlp_block_gp_plain(x, s, bb, w1, b1, w2, b2)
    assert torch.equal(out, fm.fused_mlp_block_h1(x, s, bb, w1, b1, w2, b2)[0])
    for got, want in ((out, pout), (g, pg), (gp, pgp)):
        _close(got, want, dtype)
    before = fm.fused_mlp_bwd_gp.launches
    grads = fm.fused_mlp_bwd_gp(x, do, g, gp, s, bb, w1, w2)
    for got, want in zip(grads, fm.fused_mlp_bwd_gp_plain(x, do, g, gp, s, bb, w1, w2)):
        _close_grad(got, want, dtype)
    assert fm.fused_mlp_bwd_gp.launches == before + 1
    assert _bit_equal(grads, fm.fused_mlp_bwd_gp(x, do, g, gp, s, bb, w1, w2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,k", [(70, 384, 1152), (130, 192, 576), (1, 384, 1152),
                                      (1100, 384, 1152), (36880, 384, 1152)]
                         + [(rows, d, k) for d in (192, 384) for k in (64, 192)
                            for rows in (63, 64, 65, 129)]
                         + [(rows, d, 3 * d) for d in (192, 384) for rows in (127, 129, 257)]
                         + [(rows, d, k) for d in (192, 384) for k in (128, 256, 320, 384)
                            for rows in (127, 129, 257)])
def test_ln_linear_kernels_match_plain(cuda, dtype, rows, d, k):
    """ln_linear and its backward against their twins; the forward's output
    and the backward's gradients are bit-equal across two runs (fixed-order
    sums and reductions). Around the tiles of both dtypes' kernels (64 rows a
    CTA or tile; the bf16 forward's 128-row units of 192 output columns,
    whole or cut by K; the bf16 backward's 128-row dx CTA and its weight
    kernel's 128-unit tiles, whole or cut by K; the f32 forward's 256-column
    chunks, whose last one takes 64, 128 or 192 when K is not a multiple of
    256) and at the MIM step's 36880 rows."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d + k)
    r = lambda *s, std=1.0, mean=0.0: torch.randn(*s, generator=gen, device=cuda) * std + mean  # noqa: E731
    x, dy = r(rows, d, std=2.0, mean=0.5).to(dtype), r(rows, k).to(dtype)
    w = r(k, d, std=d ** -0.5).to(dtype)
    s, bb, b = r(d, std=0.1, mean=1.0), r(d, std=0.1), r(k, std=0.1)
    bf16 = dtype == torch.bfloat16
    assert lnl.ln_linear_route(x, w) == ("ln_linear_wgmma.cu" if bf16 else "ln_linear.cu")
    assert lnl.ln_linear_bwd_route(x, w) == ("ln_linear_bwd_wgmma.cu" if bf16 else "ln_linear.cu")
    before = (lnl.ln_linear.launches, lnl.ln_linear_bwd.launches)
    y = lnl.ln_linear(x, s, bb, w, b)
    _close(y, lnl.ln_linear_plain(x, s, bb, w, b), dtype)
    assert torch.equal(y, lnl.ln_linear(x, s, bb, w, b))
    grads = lnl.ln_linear_bwd(x, dy, s, bb, w)
    for got, want in zip(grads, lnl.ln_linear_bwd_plain(x, dy, s, bb, w)):
        _close_grad(got, want, dtype)
    assert _bit_equal(grads, lnl.ln_linear_bwd(x, dy, s, bb, w))
    assert (lnl.ln_linear.launches, lnl.ln_linear_bwd.launches) == (before[0] + 2, before[1] + 2)


def test_new_wrappers_reject_layouts_they_do_not_take(cuda):
    x = torch.zeros(4, 384, device=cuda)
    v = torch.zeros(384, device=cuda)
    with pytest.raises(ValueError, match="w"):
        lnl.ln_linear(x, v, v, torch.zeros(384, 1152, device=cuda), torch.zeros(1152, device=cuda))
    with pytest.raises(ValueError, match="dy"):
        lnl.ln_linear_bwd(x, torch.zeros(4, 1151, device=cuda), v, v,
                          torch.zeros(1152, 384, device=cuda))
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="P of shape"):
        fa.flash_attention_bwd_savep(q, q, q, q, torch.zeros(2, 8, 8, device=cuda),
                                     torch.zeros(2, 8, device=cuda), q)
    w1, w2 = torch.zeros(1536, 384, device=cuda), torch.zeros(384, 1536, device=cuda)
    with pytest.raises(ValueError, match="gp"):
        fm.fused_mlp_bwd_gp(x, x, torch.zeros(4, 1536, device=cuda), x, v, v, w1, w2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,n,k", [(130, 72, 48), (1, 1, 64), (257, 129, 1536), (64, 3, 16)])
def test_probe_matmul_kernel_matches_plain(cuda, dtype, m, n, k):
    """M, N not multiples of the 128 tile, K not of the 64-byte stage. int8
    stores wrap modulo 256 and are exact; bf16 sums differ in order only."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=cuda, dtype=torch.int8)
    else:
        a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
        bt = torch.randn(n, k, generator=gen, device=cuda).to(dtype)
    before = probes.probe_matmul.launches
    got = probes.probe_matmul(a, bt)
    assert probes.probe_matmul.launches == before + 1
    want = probes.probe_matmul_plain(a, bt)
    assert got.dtype == want.dtype == dtype and got.shape == (m, n)
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("out_dtype", DTYPES)
@pytest.mark.parametrize("lead,k,n", [((3, 70), 384, 1152), ((129,), 1536, 384), ((5,), 64, 1)])
def test_int8_dot_kernel_equals_plain(cuda, out_dtype, lead, k, n):
    """Integer accumulators are exact and the dequant takes the twin's
    operations in its order: the outputs are bit-equal, bias or not."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn(*lead, k, generator=gen, device=cuda).to(out_dtype)
    x[..., 0, :] = 0  # an all-zero row takes scale 1
    w = torch.randn(n, k, generator=gen, device=cuda) * k ** -0.5
    bias = torch.randn(n, generator=gen, device=cuda)
    wq = quant.colwise_int8(w)
    for b in (bias, None):
        before = quant.int8_dot.launches
        got = quant.int8_dot(x, wq, b, out_dtype)
        assert quant.int8_dot.launches == before + 1
        want = quant.int8_dot_plain(x, wq, b, out_dtype)
        assert got.shape == (*lead, n) and got.dtype == out_dtype
        assert torch.equal(got, want)


# (operand dtype, output dtype, dequant epilogue): the GEMM's four instances
GEMM_CASES = [(torch.bfloat16, torch.bfloat16, False), (torch.int8, torch.int8, False),
              (torch.int8, torch.float32, True), (torch.int8, torch.bfloat16, True)]


@pytest.mark.parametrize("k", [16, 48, 384, 1536])
@pytest.mark.parametrize("n", [8, 384, 1160])
@pytest.mark.parametrize("m", [1, 127, 129, 4097])
@pytest.mark.parametrize("dtype,out_dtype,dequant", GEMM_CASES)
def test_matmul_wgmma_kernel_matches_plain(cuda, dtype, out_dtype, dequant, m, n, k):
    """csrc/matmul_wgmma.cu around its 128 x 128 tile and its 128-byte k
    slice (int8 K = 16: one k32 step half zero-filled) in each epilogue. int8
    is bit-equal to the twin (exact int32 sums; the dequant (float(acc) * sx)
    * sw + bias in the twin's order, with and without the bias); bf16 sums in
    another order, within 1e-2."""
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda, dtype=dtype)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=cuda, dtype=dtype)
    else:
        a = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
        bt = torch.randn(n, k, generator=gen, device=cuda).to(dtype)
    assert probes.matmul_route(a, bt, out_dtype, dequant) == "matmul_wgmma.cu"
    if not dequant:
        before = probes.probe_matmul.launches
        got, want = probes.probe_matmul(a, bt), probes.probe_matmul_plain(a, bt)
        assert probes.probe_matmul.launches == before + 1
        assert got.shape == (m, n) and got.dtype == want.dtype == out_dtype
        if dtype == torch.int8:
            assert torch.equal(got, want)
        else:
            _close(got, want, dtype)
        return
    sx = torch.rand(m, generator=gen, device=cuda) * 1e-2 + 1e-4
    sw = torch.rand(n, generator=gen, device=cuda) * 1e-2 + 1e-4
    bias = torch.randn(n, generator=gen, device=cuda)
    acc = probes.exact_product(a, bt.T)
    for b in (bias, None):
        got = probes.launch_matmul(a, bt, out_dtype, sx=sx, sw=sw, bias=b)
        want = acc * sx[:, None] * sw
        want = (want + b if b is not None else want).to(out_dtype)
        assert got.shape == (m, n) and got.dtype == out_dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [16, 48, 384, 1536, 3072])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_rows_kernel_equals_rowwise_int8(cuda, dtype, k):
    """The quantizer kernel bit-equal to rowwise_int8 on the card and on
    the CPU (true division, the JAX package's definition), values and
    scales: rows over six decades, an all-zero row, exact round-half ties of
    x / s, a row of subnormal scale, 4097 rows (a block of 8 rows past the
    last whole one); counted once, by its row width."""
    from port_helpers import quant_rows

    x = torch.from_numpy(quant_rows(4097, k, k)).to(cuda, dtype)
    x[4] *= 1e-38
    before = quant.quantize_rows.launches, quant.quantize_rows.launches_by_shape.get(str(k), 0)
    xq, s = quant.quantize_rows(x)
    assert (quant.quantize_rows.launches,
            quant.quantize_rows.launches_by_shape[str(k)]) == (before[0] + 1, before[1] + 1)
    wq, ws = quant.rowwise_int8(x)
    cq, cs = quant.rowwise_int8(x.cpu())
    assert xq.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (4097, 1)
    assert torch.equal(xq, wq) and torch.equal(s, ws)
    assert torch.equal(xq.cpu(), cq) and torch.equal(s.cpu(), cs)
    assert float(s[1]) == 1.0 and int(xq[2, 1]) == 0 and int(xq[2, 3]) == 2  # 0.5 -> 0, 2.5 -> 2


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bh,n", [(3, 2), (3, 63), (3, 64), (3, 65), (2, 127), (2, 128),
                                  (2, 129), (2, 257), (1, 8192), (1, 8193)])
def test_savep_f32_forward_matches_twin_at_tile_edges(cuda, bh, n, d):
    """The f32 saved-P forward against its twin around its key tiles (128
    at d = 64, 64 at d = 128) and its 128 query rows, and on both sides of d
    key tiles: one pass with the stored tiles rescaled up to N = 8192, a
    first pass for the max past it. Every valid row of P peaks at exactly 1
    (its true max) and its padded columns are 0."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=cuda) for _ in range(3))
    out, p, inv = fa.flash_attention_savep(q, k, v)
    pout, pp, pinv = fa.flash_attention_savep_plain(q, k, v)
    assert p.shape == pp.shape == (bh, n, fa.p_columns(n))
    assert not p[..., n:].any()
    assert bool((p[..., :n].amax(-1) == 1).all())
    _close(out, pout, torch.float32)
    _close(p, pp, torch.float32)
    err = float((inv - pinv).abs().max())
    assert err <= LSE_TOL[torch.float32] * float(pinv.abs().max()), err


# the probe kernel's tile edges: 128 query rows a CTA (64 a warpgroup), 64
# keys a tile
PROBE_ROWS, PROBE_KEYS = (1, 127, 128, 129, 130), (64, 65, 208)


def _probe_cases():
    """(variant, query rows, keys); qkvflat's rows are its keys."""
    for variant in sorted(probes.VARIANTS):
        if probes.VARIANTS[variant].layout == "qkvflat":
            yield from ((variant, n, n) for n in PROBE_KEYS)
        else:
            yield from ((variant, r, n) for r in PROBE_ROWS for n in PROBE_KEYS)


def _round_up(n, m):
    return -(-n // m) * m


def _probe_case(variant, dev, rows=130, keys=208, groups=3):
    """Inputs of one probe call, the last 5 keys padded at -1e30. folded_t's
    kt rows must be whole 16-byte steps, so its keys round up to 8."""
    var = probes.VARIANTS[variant]
    if var.layout == "folded_t":
        keys = _round_up(keys, 8)
    gen = torch.Generator(device=dev).manual_seed(keys + rows)
    bias = torch.zeros(keys, device=dev)
    bias[-5:] = -1e30  # padded keys
    r = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    if var.layout == "qkvflat":
        qkv = r(2, keys, 3 * 2 * 64)
        qkv[..., :128] *= 0.125
        return {"q": qkv, "bias": bias, "heads": 2}
    q = r(groups, rows, 64) * 0.125
    k = r(groups, 64, keys) if var.layout == "folded_t" else r(groups, keys, 64)
    v = r(groups, keys, 128 if var.layout == "folded_t" else 64)
    return {"q": q, "k": k, "v": v, "bias": bias, "scale": 1.0}


@pytest.mark.parametrize("variant,rows,keys", list(_probe_cases()))
def test_probe_attention_kernel_matches_plain(cuda, variant, rows, keys):
    """Around the kernel's tiles: 1, 127, 128, 129 and 130 query rows, 64, 65
    (72 for folded_t) and 208 keys, 5 of them padded at -1e30, 3 groups;
    qkvflat at 2 x Np rows, 2 heads."""
    kw = _probe_case(variant, cuda, rows, keys)
    assert probes.probe_attention_route(variant, **{k: v for k, v in kw.items()
                                                    if k != "scale"}) == "probe_attention_wgmma.cu"
    before = probes.probe_attention.launches
    got = probes.probe_attention(variant, **kw)
    assert probes.probe_attention.launches == before + 1
    _close(got, probes.probe_attention_plain(variant, **kw), torch.bfloat16)


@pytest.mark.parametrize("rows", PROBE_ROWS)
@pytest.mark.parametrize("keys", PROBE_KEYS)
def test_probe_attention_int8_matches_plain(cuda, rows, keys):
    """probe_dot's int8 attention: int32 products, the same exp and the same
    truncation to int8 give outputs equal to the twin's. int8 kt rows must be
    whole 16-byte steps, so the keys round up to 16 (65 -> 80)."""
    keys = _round_up(keys, 16)
    gen = torch.Generator(device=cuda).manual_seed(keys + rows)
    ri = lambda *s: torch.randint(-100, 100, s, generator=gen, device=cuda,  # noqa: E731
                                  dtype=torch.int8)
    q, kt, v = ri(3, rows, 64), ri(3, 64, keys), ri(3, keys, 128)
    bias = torch.zeros(keys, device=cuda)
    before = probes.probe_attention.launches
    got = probes.probe_attention("dot", q, kt, v, bias, 1.0 / 16.0)
    assert probes.probe_attention.launches == before + 1
    want = probes.probe_attention_plain("dot", q, kt, v, bias, 1.0 / 16.0)
    assert torch.equal(got, want)


def test_probe_wrappers_reject_layouts_they_do_not_take(cuda):
    i8 = lambda *s: torch.zeros(*s, dtype=torch.int8, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="multiple of 16"):
        probes.probe_matmul(i8(4, 24), i8(8, 24))
    with pytest.raises(ValueError, match="dtype"):
        probes.probe_matmul(i8(4, 32), torch.zeros(8, 32, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="multiple of 16"):
        quant.int8_dot(torch.zeros(4, 40, device=cuda), torch.zeros(8, 40, device=cuda))
    bias = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="int8 for 'dot' only"):
        probes.probe_attention("full", i8(1, 8, 64), i8(1, 64, 64), i8(1, 64, 64), bias)
    bf = lambda *s: torch.zeros(*s, dtype=torch.bfloat16, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="bias of 64"):
        probes.probe_attention("v0", bf(1, 8, 64), bf(1, 64, 64), bf(1, 64, 64), bias[:60])
    with pytest.raises(ValueError, match="multiple of 8"):
        probes.probe_attention("v0", bf(1, 8, 64), bf(1, 64, 60), bf(1, 60, 64), bias[:60])
    with pytest.raises(ValueError, match="qkv"):
        probes.probe_attention("qkvflat", bf(1, 8, 384), bias=bias[:8], heads=3)


@pytest.mark.parametrize("mlp", ["lnout", "kernel", "none"])
def test_vit_tiny_mosaic_int8_route_matches_plain_route(cuda, monkeypatch, mlp):
    """--quant int8 on each --infer_mlp route, f32. With the int8 GEMM's twin
    in its place the outputs are bit-equal (the kernel's integers and dequant
    are exact). Against every wrapper's twin, the attention kernel's f32
    summation order moves some round-half cases of the next quantization by
    one int8 code, so the random-weight masks agree only to the noise floor
    that bf16 shows against f32 (Dice ~0.99 at this size)."""
    model = vit.init(vit.VIT_TINY(patch_size=8), torch.Generator().manual_seed(0), cuda)
    routes = vit.InferRoutes(mlp, "int8")
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((192, 192)) * 255).astype(np.uint8)).to(cuda)
    before = quant.int8_dot.launches
    mask, attn = pl.segment_mosaic(model, img, 96, 32, routes=routes)
    assert quant.int8_dot.launches - before == 11 * (2 if mlp == "lnout" else 4)
    monkeypatch.setattr(quant, "int8_dot", quant.int8_dot_plain)
    gmask, gattn = pl.segment_mosaic(model, img, 96, 32, routes=routes)
    assert torch.equal(mask, gmask) and torch.equal(attn, gattn)
    monkeypatch.setattr(fa, "attention_qkv", fa.attention_qkv_plain)
    monkeypatch.setattr(fm, "fused_mlp_block", fm.fused_mlp_block_plain)
    monkeypatch.setattr(fm, "fused_mlp_block_lnout", fm.fused_mlp_block_lnout_plain)
    pmask, _ = pl.segment_mosaic(model, img, 96, 32, routes=routes)
    a, b = mask.cpu().numpy() > 0, pmask.cpu().numpy() > 0
    assert 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1) >= 0.98


# the eval path's shapes: the crop 16 and crop 4 tiles of a 384^2 image (145
# and 577 tokens, 16 and 4 to an image) and a whole image (2305), at batch 1
EVAL_SHAPES = [(1, 145), (16, 145), (1, 577), (4, 577), (1, 2305), (8, 2305)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n", EVAL_SHAPES)
def test_eval_shapes_kernels_match_plain(cuda, dtype, b, n):
    """Attention and both inference MLP kernels at ViT-S/8's widths and the
    eval path's token counts, against their twins."""
    gen = torch.Generator(device=cuda).manual_seed(b * n)
    r = lambda *s, std=1.0, mean=0.0: torch.randn(*s, generator=gen, device=cuda) * std + mean  # noqa: E731
    qkv = r(b, n, 3 * 384)
    qkv[..., :384] *= 64 ** -0.5
    qkv = qkv.to(dtype)
    _close(fa.attention_qkv(qkv, 6, n), fa.attention_qkv_plain(qkv, 6, n), dtype)
    x = r(b * n, 384, std=2.0, mean=0.5).to(dtype)
    w1, w2 = r(1536, 384, std=384 ** -0.5).to(dtype), r(384, 1536, std=1536 ** -0.5).to(dtype)
    args = (x, r(384, std=0.1, mean=1.0), r(384, std=0.1), w1, r(1536, std=0.1), w2,
            r(384, std=0.1))
    ln2 = (r(384, std=0.1, mean=1.0), r(384, std=0.1))
    out, z = fm.fused_mlp_block_lnout(*args, *ln2)
    pout, pz = fm.fused_mlp_block_lnout_plain(*args, *ln2)
    _close(out, pout, dtype)
    _close(z, pz, dtype)
    _close(fm.fused_mlp_block(*args), fm.fused_mlp_block_plain(*args), dtype)


def _plain_vit(monkeypatch):
    monkeypatch.setattr(fa, "attention_qkv", fa.attention_qkv_plain)
    monkeypatch.setattr(fm, "fused_mlp_block", fm.fused_mlp_block_plain)
    monkeypatch.setattr(fm, "fused_mlp_block_lnout", fm.fused_mlp_block_lnout_plain)


def test_vit_tiny_analysis_api_kernel_route_matches_plain_route(cuda, monkeypatch):
    """forward_features, get_intermediate_layers(n=4), get_last_selfattention
    and last_block_key_features of ViT-Ti/8 at 96^2, batch 1 and 2: in f32
    the kernel route within 1e-5 of max|plain route|; in bf16 the two
    routes round differently in each of 12 blocks, so each is held against
    the f32 plain route, the kernel route's error at most 1.5 times the
    plain bf16 route's. One get_intermediate_layers(n=4) launches 12
    attention, 7 LN-out and 5 plain MLP kernels."""
    model = vit.init(vit.VIT_TINY(patch_size=8), torch.Generator().manual_seed(1), cuda)
    models = {torch.float32: model, torch.bfloat16: pl.cast_params(copy.deepcopy(model),
                                                                   torch.bfloat16)}
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(2)).to(cuda)
    funcs = (vit.forward_features, lambda m, x: vit.get_intermediate_layers(m, x, 4),
             vit.get_last_selfattention, vit.last_block_key_features)
    before = (fa.attention_qkv.launches, fm.fused_mlp_block_lnout.launches,
              fm.fused_mlp_block.launches)
    vit.get_intermediate_layers(model, x, 4)
    assert (fa.attention_qkv.launches - before[0], fm.fused_mlp_block_lnout.launches - before[1],
            fm.fused_mlp_block.launches - before[2]) == (12, 7, 5)
    inputs = (x, x[:1])
    got = {dt: [[f(m, xb.to(dt)) for f in funcs] for xb in inputs] for dt, m in models.items()}
    _plain_vit(monkeypatch)
    for i, xb in enumerate(inputs):
        for j, f in enumerate(funcs):
            want = {dt: f(m, xb.to(dt)) for dt, m in models.items()}
            _close(got[torch.float32][i][j], want[torch.float32], torch.float32)
            ref = want[torch.float32].float()
            k = float((got[torch.bfloat16][i][j].float() - ref).abs().max())
            p = float((want[torch.bfloat16].float() - ref).abs().max())
            assert k <= 1.5 * p, (i, j, k, p)


def _eval_set(root, n, size):
    from PIL import Image

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "labels"))
    for i in range(n):
        img = np.full((size, size), 60.0)
        img[size // 4 : 3 * size // 4, size // 3 :] = 170
        img = np.clip(img + rng.normal(0, 25, img.shape), 0, 255).astype(np.uint8)
        lab = np.zeros((size, size), np.uint8)
        lab[size // 4 : 3 * size // 4, size // 3 :] = 255
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.png"))
        Image.fromarray(lab).save(os.path.join(root, "labels", f"{i}.png"))


@pytest.mark.parametrize("method,crop", [("ours", 1), ("heatmap_threshold", 1), ("ours", 4),
                                         ("ours", 16), ("k-means_ours", 1), ("chan-vese", 1),
                                         ("k-means_feature_clustering", 1)])
def test_vit_tiny_eval_kernel_route_matches_plain_route(cuda, monkeypatch, tmp_path, method,
                                                        crop):
    """validate() of ViT-Ti/8 on 4 labeled 96^2 images, f32: per-image masks
    of the kernel route against the plain route's, Dice >= 0.99; every metric
    in [0, 1]; batch 4 against batch 1 within 1e-5 where it batches."""
    from vit_ocm_wmsegmentation_tpu_torch import evaluation as ev
    from vit_ocm_wmsegmentation_tpu_torch.data.datasets import build_eval_samples

    _eval_set(str(tmp_path), 4, 96)
    samples = build_eval_samples(str(tmp_path), 96, crop=crop)
    model = vit.init(vit.VIT_TINY(patch_size=8), torch.Generator().manual_seed(3), cuda)

    def run(**kw):
        meters, masks = {}, []
        ev.validate(model, samples, method=method, crop=crop, meters_out=meters,
                    masks_out=masks, **kw)
        assert all(0.0 <= meters[k].avg <= 1.0 for k in ("loss", "acc", "f1", "jaccard"))
        return {k: m.avg for k, m in meters.items() if k != "time"}, masks

    meters, masks = run()
    if crop == 1 and method in ev.BATCHED_METHODS:
        batched, _ = run(batch_size=4)
        assert all(abs(batched[k] - meters[k]) <= 1e-5 for k in meters)
    _plain_vit(monkeypatch)
    _, plain = run()
    for a, b in zip(masks, plain):
        a, b = a > 0, b > 0
        assert 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1) >= 0.99


@pytest.mark.parametrize("layer_num", [1, 2])
def test_finetune_step_kernel_route_matches_plain_route(cuda, layer_num):
    """One LinearProbing Dice step (ViT-S/8 width at depth 2, 64^2, batch 2,
    f32): the loss within rtol 1e-5 and every gradient within 1e-4 of
    max|plain gradient| of the plain route's (the conv bias before the
    decoder's BatchNorm, whose gradient BatchNorm cancels, within 1e-4 of
    the largest gradient); the step launches the four
    training kernels once a block, the eval forward the inference route's."""
    from vit_ocm_wmsegmentation_tpu_torch.models import probing
    from vit_ocm_wmsegmentation_tpu_torch.ops.metrics import dice_loss
    from vit_ocm_wmsegmentation_tpu_torch.ops.twins import plain_training_route
    from vit_ocm_wmsegmentation_tpu_torch.train import supervised as sup

    cfg = vit.ViTConfig(depth=2, pretrain_img_size=64)
    model = probing.init(cfg, torch.Generator().manual_seed(0), layer_num, device=cuda)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 64, 64, 3), dtype=np.float32)).to(cuda)
    y = torch.from_numpy((rng.random((2, 64, 64, 1)) > 0.5).astype(np.float32)).to(cuda)

    def step():
        loss = dice_loss(probing.apply(model, x, True), y)
        return float(loss.detach()), torch.autograd.grad(loss, list(model.parameters()))

    names = ("flash_attention", "flash_attention_bwd", "fused_mlp_block_h1", "fused_mlp_bwd")
    before = [getattr(fa if n.startswith("flash") else fm, n).launches for n in names]
    loss, grads = step()
    after = [getattr(fa if n.startswith("flash") else fm, n).launches for n in names]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 2]
    with plain_training_route():
        ploss, pgrads = step()
    assert abs(loss - ploss) <= 1e-5 * abs(ploss)
    top = max(float(p.abs().max()) for p in pgrads)
    for (name, _), g, p in zip(model.named_parameters(), grads, pgrads):
        # BatchNorm cancels the bias of the conv before it: its gradient is
        # 0 up to rounding, so it is held to the largest gradient's scale
        scale = top if name == "two_layer_decoder.0.bias" else float(p.abs().max())
        assert float((g - p).abs().max()) <= 1e-4 * max(scale, 1e-30), name
    _, eval_step = sup.make_seg_step(probing.apply, model, sup.make_adam(model, 1e-4))
    before = fa.attention_qkv.launches
    eval_step(x, y)
    assert fa.attention_qkv.launches == before + 2


def test_teacher_pseudo_labels_kernel_route_matches_plain_route(cuda, monkeypatch):
    """The PGT teacher (ViT-S/8 width at depth 4, batch 3 of 96^2 pieces of
    a blob image, f32): masks of the kernel route against the plain route's,
    Dice >= 0.99, {0, 1} valued; 3 attention, 2 LN-out and 1 plain MLP
    launches a batch."""
    from vit_ocm_wmsegmentation_tpu_torch.train import supervised as sup

    teacher = vit.init(vit.ViTConfig(depth=4), torch.Generator().manual_seed(2), cuda)
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:96, :96]
    base = ((yy // 24 + xx // 24) % 2 * 0.5 + 0.25)[None, ..., None]
    x = torch.from_numpy((base + rng.normal(0, 0.1, (3, 96, 96, 3))).clip(0, 1)
                         .astype(np.float32)).to(cuda)
    counts = (fa.attention_qkv.launches, fm.fused_mlp_block_lnout.launches,
              fm.fused_mlp_block.launches)
    masks = sup.teacher_pseudo_labels(teacher, x)
    assert (fa.attention_qkv.launches - counts[0], fm.fused_mlp_block_lnout.launches - counts[1],
            fm.fused_mlp_block.launches - counts[2]) == (3, 2, 1)
    _plain_vit(monkeypatch)
    plain = sup.teacher_pseudo_labels(teacher, x)
    assert set(torch.unique(masks).tolist()) <= {0.0, 1.0}
    a, b = masks.cpu().numpy() > 0, plain.cpu().numpy() > 0
    assert 2 * np.logical_and(a, b).sum() / max(a.sum() + b.sum(), 1) >= 0.99


@pytest.mark.parametrize("k", [1, 2])
def test_step_returns_each_calls_own_outputs_and_updates_once_on_the_card(cuda, k):
    """The CPU test's check (port_helpers) on the card: with k = 1 the step
    is a CUDA graph, captured once on call 2 and replayed on calls 2-5, and
    every call still returns fresh tensors and applies one update at its own
    rate, and a batch of another shape after the capture raises; with k = 2
    (accumulation) every call runs eagerly."""
    from port_helpers import check_step_outputs_and_updates

    from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import GraphedStep

    step = check_step_outputs_and_updates(cuda, k)
    assert isinstance(step, GraphedStep) == (k == 1)
    if k == 1:
        assert (step.captures, step.replays) == (1, 4)
        # a batch of another size after the capture is refused, not run
        x, mask = torch.rand(1, 32, 32, 3, device=cuda), torch.ones(1, 4, 4, dtype=torch.int32,
                                                                     device=cuda)
        with pytest.raises(ValueError, match="captured"):
            step(x, mask)
        assert (step.captures, step.replays, step.optimizer.updates) == (1, 4, 5)


def _mim_route_cases():
    from vit_ocm_wmsegmentation_tpu_torch.train import mim_trainer as mt

    return [(key, c) for key, choices in (("MLP_REMAT", mt.MLP_REMAT_CHOICES),
                                          ("LN_QKV", mt.LN_QKV_CHOICES),
                                          ("ATTN_SAVE_P", mt.ATTN_SAVE_P_CHOICES))
            for c in choices]


def _mim_cell_step(cuda, amp, routes, graphed, remat=False):
    """The benchmark cell's model (simmim.mim_vit_config(384): width 384,
    depth 4, 3 heads of 128) from seed 0, its optimizer at the MIM config's
    defaults on a schedule that changes every update, and either
    make_train_step's step or the step's uncaptured body (the eager step's
    own: the update's host part, then its device part); ``remat`` is
    TRAIN.USE_CHECKPOINT."""
    from vit_ocm_wmsegmentation_tpu_torch.models import simmim
    from vit_ocm_wmsegmentation_tpu_torch.train import mim_trainer as mt
    from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer
    from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

    model = simmim.init(simmim.mim_vit_config(384, 8), torch.Generator().manual_seed(0), cuda)
    opt = Optimizer(default_config(), model, lambda t: 1e-4 * (t + 1))
    if graphed:
        step = mt.make_train_step(model, opt, amp=amp, remat=remat, routes=routes)
    else:
        step = mt._step_body(model, opt, opt.step, amp=amp, remat=remat, routes=routes)
    return model, opt, step


def _mim_batches(cuda, n, b=4):
    gen = torch.Generator(device=cuda).manual_seed(11)
    return [(torch.rand(b, 384, 384, 3, generator=gen, device=cuda),
             (torch.rand(b, 48, 48, generator=gen, device=cuda) > 0.5).to(torch.int32))
            for _ in range(n)]


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("key,choice", _mim_route_cases())
def test_graphed_mim_step_is_bit_equal_to_its_eager_body(cuda, amp, key, choice, remat):
    """Five steps of the one-device MIM step (batch 4 of 384^2), captured on
    call 2 and replayed, against five calls of its uncaptured body with the
    same capturable optimizer: loss, grad norm, every parameter and AdamW's
    first moment bit-equal, for each choice of TRAIN.MLP_REMAT, LN_QKV and
    ATTN_SAVE_P that the CLI offers (the others at auto), with and without
    TRAIN.USE_CHECKPOINT (whose recompute runs inside the capture), so that
    every kernel route is shown to capture; one capture, four replays."""
    from vit_ocm_wmsegmentation_tpu_torch.train import mim_trainer as mt
    from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

    cfg = default_config()
    cfg.TRAIN[key] = choice
    routes = mt.train_routes(cfg)
    gmodel, gopt, graphed = _mim_cell_step(cuda, amp, routes, graphed=True, remat=remat)
    emodel, eopt, body = _mim_cell_step(cuda, amp, routes, graphed=False, remat=remat)
    assert isinstance(graphed, mt.GraphedStep)
    for n, (x, mask) in enumerate(_mim_batches(cuda, 5)):
        got, want = graphed(x, mask), body(x, mask)
        for g, w, what in zip(got, want, ("loss", "grad norm")):
            assert torch.equal(g, w), (n, what, float(g), float(w))
    assert (graphed.captures, graphed.replays) == (1, 4)
    assert gopt.updates == eopt.updates == 5
    for (name, p), q in zip(gmodel.named_parameters(), emodel.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(gopt.opt.state[p]["exp_avg"], eopt.opt.state[q]["exp_avg"]), name


def _span_tree(events, prefix="mim.", parent=None):
    """[(name, children)] of the profiler's host spans named ``prefix``*,
    each under its nearest such ancestor (the device's copies of the spans,
    on the kernels' clock, left out)."""
    from torch.autograd import DeviceType

    def nearest(e):
        p = e.cpu_parent
        while p is not None and not (p.is_user_annotation and p.name.startswith(prefix)):
            p = p.cpu_parent
        return p

    mine = sorted((e for e in events if e.is_user_annotation and e.name.startswith(prefix)
                   and e.device_type == DeviceType.CPU and nearest(e) is parent),
                  key=lambda e: e.time_range.start)
    return [(e.name, _span_tree(events, prefix, e)) for e in mine]


def test_graphed_mim_step_trace_names_the_kernels_under_its_spans(cuda, tmp_path):
    """The AMP step (batch 4 of 384^2) under utils.profiling.trace: the
    capturing call (call 2) keeps forward, backward and optimizer under
    ``mim.capture``; a replayed call is ``mim.step`` over ``mim.inputs`` and
    ``mim.replay``, and its trace (profiling.device_ops) lists by name the
    bf16 attention kernels, forward and backward, and the MLP kernels that
    the benchmark's rooflines read, launched under ``mim.replay``."""
    import json
    import re

    from vit_ocm_wmsegmentation_tpu_torch.models.vit import TrainRoutes
    from vit_ocm_wmsegmentation_tpu_torch.utils import profiling

    _, _, step = _mim_cell_step(cuda, True, TrainRoutes(), graphed=True)
    (x1, m1), (x2, m2), (x3, m3) = _mim_batches(cuda, 3)
    step(x1, m1)
    with profiling.trace(str(tmp_path / "capture")) as prof:
        step(x2, m2)
    leaves = [("mim.forward", []), ("mim.backward", []), ("mim.optimizer", [])]
    assert _span_tree(prof.events()) == [
        ("mim.step", [("mim.inputs", []), ("mim.capture", leaves), ("mim.replay", [])])]
    with profiling.trace(str(tmp_path / "replay")) as prof:
        step(x3, m3)
    assert _span_tree(prof.events()) == [("mim.step", [("mim.inputs", []), ("mim.replay", [])])]
    assert (step.captures, step.replays) == (1, 2)
    with open(tmp_path / "replay" / "trace.json") as f:
        ops = profiling.device_ops(json.load(f))
    replayed = [name for name, _, _, span in ops if span == "mim.replay"]
    for pattern in (r"attn_bwd_dkdv_wgmma_kernel", r"attn_bwd_dq_wgmma_kernel",
                    r"attention_wgmma_kernel\W*128", r"fused_mlp_wgmma_kernel",
                    r"mlp_bwd_dx_wgmma_kernel", r"mlp_bwd_w_wgmma_kernel"):
        assert any(re.search(pattern, n) for n in replayed), (pattern, sorted(set(replayed))[:40])
    assert {span for *_, span in ops} <= {"mim.inputs", "mim.replay"}


def test_graphed_mim_step_resumes_a_state_written_without_capture(cuda):
    """An optimizer state of a CPU run (AdamW not capturable, its step counts
    on the host) loads into the card's optimizer: the groups become
    capturable with the device rate, the counts move to the card, and the
    graphed step then captures and replays, each call one update."""
    from vit_ocm_wmsegmentation_tpu_torch.models import simmim
    from vit_ocm_wmsegmentation_tpu_torch.train.mim_trainer import make_train_step
    from vit_ocm_wmsegmentation_tpu_torch.train.optim import Optimizer
    from vit_ocm_wmsegmentation_tpu_torch.utils.config import default_config

    cfg = vit.ViTConfig(patch_size=8, embed_dim=384, depth=1, num_heads=3, pretrain_img_size=32)
    host = simmim.init(cfg, torch.Generator().manual_seed(8))
    rng = np.random.default_rng(3)
    batches = [(torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32)),
                torch.from_numpy((rng.random((2, 4, 4)) > 0.5).astype(np.int32)))
               for _ in range(4)]
    hopt = Optimizer(default_config(), host, lambda t: 1e-3)
    make_train_step(host, hopt)(*batches[0])
    model = copy.deepcopy(host).to(cuda)
    opt = Optimizer(default_config(), model, lambda t: 1e-3)
    opt.load_state_dict(hopt.state_dict())
    assert all(g["capturable"] and torch.is_tensor(g["lr"]) and g["lr"].is_cuda
               for g in opt.opt.param_groups)
    step = make_train_step(model, opt)
    for x, mask in batches[1:]:
        step(x.to(cuda), mask.to(cuda))
    assert (step.captures, step.replays, opt.updates) == (1, 2, 4)
    steps = [st["step"] for st in opt.opt.state.values()]
    assert all(s.device.type == "cuda" for s in steps) and {float(s) for s in steps} == {4.0}
