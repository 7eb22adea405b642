"""Which kernel each wrapper launches, decided on the CPU.

The wrappers choose their kernel by route, explicitly (no fallback):
bfloat16 inference takes the wgmma kernels (csrc/attention_qkv_wgmma.cu,
csrc/fused_mlp_serve_wgmma.cu), as does the bfloat16 training attention, forward
(csrc/attention_qkv_wgmma.cu) and backward (csrc/attention_bwd_wgmma.cu),
and on the saved-P route both ways (csrc/attention_savep_wgmma.cu,
csrc/attention_savep_bwd_wgmma.cu); the bfloat16 MLP training forward takes
its own wgmma kernel (csrc/fused_mlp_wgmma.cu), float32 the CUDA-core ones, as does LN -> qkv
(csrc/ln_linear.cu both ways; bfloat16 csrc/ln_linear_wgmma.cu forward and
csrc/ln_linear_bwd_wgmma.cu backward); the tiled GEMM of the probes and the int8 route takes
csrc/matmul_wgmma.cu in every dtype and epilogue, and every attention probe
csrc/probe_attention_wgmma.cu. The route functions read
only shapes, dtypes and layouts, so these tests run without a card; on the
CPU the wrappers take their plain twins and count no launch.
"""

import pytest
import torch

from vit_ocm_wmsegmentation_tpu_torch.ops import flash_attention as fa
from vit_ocm_wmsegmentation_tpu_torch.ops import fused_mlp as fm
from vit_ocm_wmsegmentation_tpu_torch.ops import ln_linear as lnl
from vit_ocm_wmsegmentation_tpu_torch.ops import probes
from vit_ocm_wmsegmentation_tpu_torch.ops import quant

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32


def _qkv(dtype, heads=2, d=64, rows=10):
    return torch.zeros(2, rows, 3 * heads * d, dtype=dtype)


def _mlp(dtype, d=384, h=1536, rows=5):
    return (torch.zeros(rows, d, dtype=dtype), torch.zeros(h, d, dtype=dtype),
            torch.zeros(d, h, dtype=dtype))


@pytest.mark.parametrize("dtype,d,want", [(F32, 64, "attention_qkv.cu"),
                                          (F32, 128, "attention_qkv.cu"),
                                          (BF16, 64, "attention_qkv_wgmma.cu"),
                                          (BF16, 128, "attention_qkv_wgmma.cu")])
def test_attention_route_names_the_kernel(dtype, d, want):
    assert fa.attention_qkv_route(_qkv(dtype, d=d), 2, 10) == want


ATTN_ROUTES = {"flash_attention": (fa.flash_attention_route, "attention_qkv.cu",
                                   "attention_qkv_wgmma.cu"),
               "flash_attention_bwd": (fa.flash_attention_bwd_route, "attention_bwd.cu",
                                       "attention_bwd_wgmma.cu"),
               "flash_attention_savep": (fa.flash_attention_savep_route, "attention_savep.cu",
                                         "attention_savep_wgmma.cu"),
               "flash_attention_bwd_savep": (fa.flash_attention_bwd_savep_route,
                                             "attention_savep.cu",
                                             "attention_savep_bwd_wgmma.cu")}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("name", sorted(ATTN_ROUTES))
def test_training_attention_routes_name_the_kernel(name, dtype, d):
    route, f32_source, bf16_source = ATTN_ROUTES[name]
    q = torch.zeros(6, 130, d, dtype=dtype)
    forward = name in ("flash_attention", "flash_attention_savep")
    others = (q,) * (2 if forward else 4)  # k, v (and o, do)
    assert route(q, *others) == (bf16_source if dtype == BF16 else f32_source)
    assert route(q) == route(q, *others)


@pytest.mark.parametrize("case,match", [
    ("head dim 96", "head dim"),
    ("not contiguous", "contiguous"),
    ("misaligned", "16-byte aligned"),
    ("mixed dtypes", "share"),
    ("meta device", "no kernel for device meta"),
])
@pytest.mark.parametrize("name", sorted(ATTN_ROUTES))
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_training_attention_routes_raise_on_what_no_kernel_takes(dtype, name, case, match):
    """Both dtypes: the f32 kernels, like the bf16 ones, stage their rows in
    16-byte copies."""
    route = ATTN_ROUTES[name][0]
    q, others = torch.zeros(2, 10, 64, dtype=dtype), ()
    if case == "head dim 96":
        q = torch.zeros(2, 10, 96, dtype=dtype)
    elif case == "not contiguous":
        q = torch.zeros(2, 64, 10, dtype=dtype).transpose(1, 2)
    elif case == "misaligned":  # one element past a 16-byte boundary
        q = torch.zeros(2 * 10 * 64 + 1, dtype=dtype)[1:].view(2, 10, 64)
        assert q.is_contiguous() and q.data_ptr() % 16
    elif case == "mixed dtypes":
        others = (q, q.to(BF16 if dtype == F32 else F32))
    else:
        q = q.to("meta")
    with pytest.raises(ValueError, match=match):
        route(q, *others)


@pytest.mark.parametrize("dtype,d,h,residual,want", [
    (BF16, 384, 1536, None, "fused_mlp_serve_wgmma.cu"),
    (BF16, 192, 800, None, "fused_mlp_serve_wgmma.cu"),  # H a multiple of the wgmma chunk only
    (BF16, 384, 1536, "h1", "fused_mlp_wgmma.cu"),
    (BF16, 192, 768, "gp", "fused_mlp_wgmma.cu"),
    # the training routes too: H a multiple of the 32-unit chunk, not of 64
    (BF16, 192, 800, "h1", "fused_mlp_wgmma.cu"),
    (BF16, 384, 1568, "gp", "fused_mlp_wgmma.cu"),
    (F32, 384, 1536, None, "fused_mlp.cu"),
    (F32, 192, 768, "h1", "fused_mlp.cu"),
    # f32: H a multiple of 64, not of the kernels' 128-unit chunk
    (F32, 384, 832, None, "fused_mlp.cu"),
    (F32, 192, 832, "gp", "fused_mlp.cu"),
    (F32, 384, 64, "h1", "fused_mlp.cu"),
])
def test_mlp_route_names_the_kernel(dtype, d, h, residual, want):
    assert fm.mlp_route(*_mlp(dtype, d, h), residual) == want


@pytest.mark.parametrize("d,h", [(384, 1536), (192, 768), (384, 1568), (192, 800)])
def test_bf16_mlp_inference_and_training_take_their_own_sources(d, h):
    """A bfloat16 call with no residual outputs (fused_mlp_block,
    fused_mlp_block_lnout: serving, eval, analysis, the PGT teacher) takes
    csrc/fused_mlp_serve_wgmma.cu; the training routes, which save h1 or g
    and gp, csrc/fused_mlp_wgmma.cu; the backward's check reads the
    training forward's route."""
    x, w1, w2 = _mlp(BF16, d, h)
    assert fm.mlp_route(x, w1, w2) == "fused_mlp_serve_wgmma.cu"
    assert fm.mlp_route(x, w1, w2, "h1") == "fused_mlp_wgmma.cu"
    assert fm.mlp_route(x, w1, w2, "gp") == "fused_mlp_wgmma.cu"
    assert fm.mlp_bwd_route(*_bwd(BF16, d, h)) == "fused_mlp_bwd_wgmma.cu"


@pytest.mark.parametrize("residual", [None, "h1", "gp"])
@pytest.mark.parametrize("d,h,match", [(384, 48, "H % 64"), (384, 800, "H % 64"),
                                       (384, 1568, "H % 64"), (256, 1024, "D in")])
def test_f32_mlp_route_raises_on_what_no_kernel_takes(d, h, residual, match):
    """The f32 kernels take H in multiples of 64 (a last chunk of 64 units
    is masked) and D in {192, 384}, on every route."""
    with pytest.raises(ValueError, match=match):
        fm.mlp_route(*_mlp(F32, d, h), residual)


def _bwd(dtype, d=384, h=1536, rows=5, gp=False):
    x, w1, w2 = _mlp(dtype, d, h, rows)
    hidden = torch.zeros(rows, h, dtype=dtype)
    return x, x.clone(), hidden, w1, w2, (hidden.clone() if gp else None)


@pytest.mark.parametrize("gp", [False, True])
@pytest.mark.parametrize("dtype,d,h,want", [(F32, 384, 1536, "fused_mlp_bwd.cu"),
                                            (F32, 192, 832, "fused_mlp_bwd.cu"),
                                            (BF16, 384, 1536, "fused_mlp_bwd_wgmma.cu"),
                                            (BF16, 192, 800, "fused_mlp_bwd_wgmma.cu")])
def test_mlp_bwd_route_names_the_kernel(dtype, d, h, want, gp):
    assert fm.mlp_bwd_route(*_bwd(dtype, d, h, gp=gp)) == want


@pytest.mark.parametrize("case,match", [
    ("do rows", "do must be"), ("h1 width", "h1 must be"), ("g dtype", "g must be"),
    ("gp misaligned", "gp must be"), ("H 800", "H % 64"), ("h1 not contiguous", "h1 must be"),
    ("bf16 H 816", "H % 32"),
])
def test_mlp_bwd_route_raises_on_what_no_kernel_takes(case, match):
    x, do, h1, w1, w2, gp = _bwd(F32, gp=case.startswith(("g ", "gp")))
    if case == "do rows":
        do = torch.zeros(4, 384)
    elif case == "h1 width":
        h1 = torch.zeros(5, 1535)
    elif case == "g dtype":
        h1 = h1.to(BF16)
    elif case == "gp misaligned":  # one element past a 16-byte boundary
        gp = torch.zeros(5 * 1536 + 1)[1:].view(5, 1536)
    elif case == "H 800":
        x, do, h1, w1, w2, gp = _bwd(F32, h=800)
    elif case == "bf16 H 816":
        x, do, h1, w1, w2, gp = _bwd(BF16, h=816)
    else:
        h1 = torch.zeros(1536, 5).T
    with pytest.raises(ValueError, match=match):
        fm.mlp_bwd_route(x, do, h1, w1, w2, gp)


@pytest.mark.parametrize("rows,sms,want", [
    (1, 132, (1, 1)), (16896, 132, (132, 1)),  # one wave: nothing split
    (16897, 132, (132, 4)),  # one tile past it, split 4 ways
    (36880, 132, (264, 4)),  # the MIM step: 289 tiles, 25 past two waves
    (33792, 132, (264, 1)),  # whole waves
    (36880, 114, (289, 1)),  # 61 tiles past two waves of 114: 114 // 61 = 1, none split
    (31744, 114, (228, 4)), (34304, 114, (228, 2)),  # 20 and 40 past two waves
])
def test_fwd_split_runs_the_last_wave_in_parts(rows, sms, want):
    """The bf16 training forward's tail tiles: (split_from, parts)."""
    assert fm.fwd_split(rows, sms) == want


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 127, 128, 129, 36880])
@pytest.mark.parametrize("dtype,gp,hidden", [(F32, False, 2), (F32, True, 1), (BF16, False, 2),
                                             (BF16, True, 1)])
def test_mlp_bwd_workspace_sizes(rows, dtype, gp, hidden):
    """part: the split partials, then the dx kernel's dh1 (R, H) and, on the
    save-h1 route, g (R, H), in the storage dtype; ln_part a row a 64-row
    tile. float32: partials of 2 H D + H + D values, rows of 2 D ([ds |
    dbb]); bfloat16: partials of 2 H D + H (db2 moved to ln_part), dh1 and g
    two to an f32 value, rows of 3 D ([db2 | ds | dbb])."""
    d, h = 384, 1536
    part, ln_part = fm.bwd_workspace(rows, d, h, dtype, gp)
    assert fm._BWD_MIN_TILE == 64
    if dtype == F32:
        assert part == fm.MLP_SPLITS * (2 * h * d + h + d) + hidden * rows * h
        assert ln_part == -(-rows // 64) * 2 * d
    else:
        assert part == fm.MLP_SPLITS * (2 * h * d + h) + hidden * rows * h // 2
        assert ln_part == -(-rows // 64) * 3 * d


@pytest.mark.parametrize("d", [192, 384])
@pytest.mark.parametrize("dtype,want", [(F32, "ln_linear.cu"), (BF16, "ln_linear_wgmma.cu")])
def test_ln_linear_route_names_the_kernel(dtype, want, d):
    """LN -> qkv forward: float32 the register-tiled kernel, bfloat16 the
    wgmma one; K = 3 D, as the qkv projection has it."""
    x, w = torch.zeros(5, d, dtype=dtype), torch.zeros(3 * d, d, dtype=dtype)
    assert lnl.ln_linear_route(x, w) == want


@pytest.mark.parametrize("d", [192, 384])
@pytest.mark.parametrize("dtype,want", [(F32, "ln_linear.cu"), (BF16, "ln_linear_bwd_wgmma.cu")])
def test_ln_linear_bwd_route_names_the_kernel(dtype, want, d):
    """LN -> qkv backward: float32 the register-tiled kernels, bfloat16 the
    wgmma dx and weight kernels; K = 3 D."""
    x, w = torch.zeros(5, d, dtype=dtype), torch.zeros(3 * d, d, dtype=dtype)
    assert lnl.ln_linear_bwd_route(x, w) == want


@pytest.mark.parametrize("case,match", [
    ("K 1120", "K % 64"), ("D 256", "D in"), ("w transposed", "w must be"),
    ("w strided", "w must be"), ("w bfloat16", "w must be"),
])
def test_ln_linear_route_raises_on_what_no_kernel_takes(case, match):
    """K a multiple of 64 (the kernels' column chunk), D in {192, 384}, w a
    contiguous (K, D) tensor of x's dtype; both directions' routes refuse."""
    x, w = torch.zeros(5, 384), torch.zeros(1152, 384)
    if case == "K 1120":
        w = torch.zeros(1120, 384)
    elif case == "D 256":
        x, w = torch.zeros(5, 256), torch.zeros(768, 256)
    elif case == "w transposed":
        w = torch.zeros(384, 1152).T
    elif case == "w strided":
        w = torch.zeros(1152, 768)[:, ::2]
    else:
        w = w.to(BF16)
    for route in (lnl.ln_linear_route, lnl.ln_linear_bwd_route):
        with pytest.raises(ValueError, match=match):
            route(x, w)


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 127, 128, 129, 257, 36880])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ln_linear_bwd_workspace_sizes(rows, dtype):
    """part: LN_SPLITS partials of [dW (K, D) | db (K)]; ln_part a row of
    [ds | dbb] (2 D) a 64-row tile, both storage types alike: a float32 dx
    CTA, a consumer warpgroup of the bfloat16 dx kernel's 128-row CTA (the
    second one's row is past the last when its rows are)."""
    d, k = 384, 1152
    part, ln_part = lnl.bwd_workspace(rows, d, k, dtype)
    assert lnl._BWD_MIN_TILE == 64
    assert part == lnl.LN_SPLITS * (k * d + k)
    assert ln_part == -(-rows // 64) * 2 * d


@pytest.mark.parametrize("case,match", [
    ("head dim 32", "head dim"),
    ("n = 0", "outside"),
    ("n past the rows", "outside"),
    ("float16", "float32/bfloat16"),
    ("not contiguous", "contiguous"),
    ("misaligned", "16-byte aligned"),
])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_attention_route_raises_on_what_no_kernel_takes(dtype, case, match):
    """Both dtypes: both kernels read qkv in 16-byte copies (cp.async for
    f32, TMA for bf16), so a qkv whose start is not 16-byte aligned raises."""
    qkv, heads, n = _qkv(dtype), 2, 10
    if case == "head dim 32":
        qkv = _qkv(dtype, d=32)
    elif case == "n = 0":
        n = 0
    elif case == "n past the rows":
        n = 11
    elif case == "float16":
        qkv = qkv.half()
    elif case == "misaligned":  # one element past a 16-byte boundary
        qkv = torch.zeros(2 * 10 * 384 + 1, dtype=dtype)[1:].view(2, 10, 384)
        assert qkv.is_contiguous() and qkv.data_ptr() % 16
    else:
        qkv = qkv.transpose(0, 1)
    with pytest.raises(ValueError, match=match):
        fa.attention_qkv_route(qkv, heads, n)


@pytest.mark.parametrize("case,match", [
    ("D 256", "D in"),
    ("H 48", "H % 32"),
    ("training H 800", "H % 64"),
    ("bf16 training H 816", "H % 32"),
    ("swapped weights", "w1"),
    ("mixed dtypes", "must be contiguous"),
    ("1-D x", r"\(R, D\)"),
])
def test_mlp_route_raises_on_what_no_kernel_takes(case, match):
    residual = None
    x, w1, w2 = _mlp(BF16)
    if case == "D 256":
        x, w1, w2 = _mlp(BF16, d=256, h=1024)
    elif case == "H 48":
        x, w1, w2 = _mlp(BF16, h=48)
    elif case == "training H 800":  # f32: H a multiple of 64 on every route
        x, w1, w2 = _mlp(F32, d=192, h=800)
        residual = "h1"
    elif case == "bf16 training H 816":  # bf16: a multiple of the 32-unit chunk
        x, w1, w2 = _mlp(BF16, d=192, h=816)
        residual = "gp"
    elif case == "swapped weights":
        w1, w2 = w2, w1
    elif case == "mixed dtypes":
        w1 = w1.float()
    else:
        x = x[0]
    with pytest.raises(ValueError, match=match):
        fm.mlp_route(x, w1, w2, residual)


def _call(name, dtype):
    if name == "attention_qkv":
        return fa.attention_qkv(_qkv(dtype), 2, 10)
    if name.startswith("flash_attention"):
        q = torch.randn(2, 10, 64).to(dtype)
        if name == "flash_attention":
            return fa.flash_attention(q, q, q)
        if name == "flash_attention_savep":
            return fa.flash_attention_savep(q, q, q)
        o, lse = fa.flash_attention(q, q, q)
        return fa.flash_attention_bwd(q, q, q, o, lse, q)
    if name == "ln_linear_bwd":
        x, w, v = torch.randn(5, 192).to(dtype), torch.zeros(576, 192, dtype=dtype), torch.ones(192)
        return lnl.ln_linear_bwd(x, torch.zeros(5, 576, dtype=dtype), v, v, w)
    x, w1, w2 = _mlp(dtype, d=192, h=768)
    v, b1 = torch.zeros(192), torch.zeros(768)
    if name == "fused_mlp_block":
        return fm.fused_mlp_block(x, v, v, w1, b1, w2, v)
    return fm.fused_mlp_block_lnout(x, v, v, w1, b1, w2, v, v, v)


WRAPPERS = {"attention_qkv": fa, "fused_mlp_block": fm, "fused_mlp_block_lnout": fm,
            "flash_attention": fa, "flash_attention_bwd": fa, "flash_attention_savep": fa,
            "ln_linear_bwd": lnl}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_cpu_calls_take_the_twin_and_count_no_launch(name, dtype):
    wrapper = getattr(WRAPPERS[name], name)
    before = wrapper.launches
    out = _call(name, dtype)
    out = out if torch.is_tensor(out) else out[0]
    assert out.dtype == dtype and out.device.type == "cpu"
    assert wrapper.launches == before


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_raise_on_devices_without_a_kernel(name):
    """Neither the CPU nor CUDA: no twin, no kernel, an error."""
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if name == "attention_qkv":
            fa.attention_qkv(_qkv(BF16).to("meta"), 2, 10)
        elif name.startswith("flash_attention"):
            q = torch.zeros(2, 10, 64, dtype=BF16, device="meta")
            if name == "flash_attention":
                fa.flash_attention(q, q, q)
            elif name == "flash_attention_savep":
                fa.flash_attention_savep(q, q, q)
            else:
                fa.flash_attention_bwd(q, q, q, q, torch.zeros(2, 10, device="meta"), q)
        elif name == "ln_linear_bwd":
            x, w = torch.zeros(5, 384, device="meta"), torch.zeros(1152, 384, device="meta")
            lnl.ln_linear_bwd(x, torch.zeros(5, 1152, device="meta"), x[0], x[0], w)
        else:
            x, w1, w2 = (t.to("meta") for t in _mlp(BF16))
            v = torch.zeros(384, device="meta")
            b1 = torch.zeros(1536, device="meta")
            if name == "fused_mlp_block":
                fm.fused_mlp_block(x, v, v, w1, b1, w2, v)
            else:
                fm.fused_mlp_block_lnout(x, v, v, w1, b1, w2, v, v, v)


I8 = torch.int8


@pytest.mark.parametrize("dtype,out_dtype,dequant", [(BF16, BF16, False), (I8, I8, False),
                                                     (I8, F32, True), (I8, BF16, True)])
@pytest.mark.parametrize("k", [16, 48, 384, 1536])
def test_matmul_route_names_the_kernel(dtype, out_dtype, dequant, k):
    """Every dtype and epilogue of the GEMM, at K from one 16-byte row step
    (int8 K = 16: half a k32 step) to the MLP's width, on any M and N."""
    a, bt = torch.zeros(130, k, dtype=dtype), torch.zeros(1160, k, dtype=dtype)
    assert probes.matmul_route(a, bt, out_dtype, dequant) == "matmul_wgmma.cu"


@pytest.mark.parametrize("case,match", [
    ("K * itemsize", "multiple of 16 bytes"), ("mixed dtypes", "one dtype"),
    ("K mismatch", "one dtype"), ("3-D a", "one dtype"), ("bf16 to f32", "no kernel"),
    ("int8 dequant to int8", "no kernel"), ("bf16 dequant", "no kernel"),
    ("f32 operands", "no kernel")])
def test_matmul_route_raises_on_what_no_kernel_takes(case, match):
    a, bt, out, dq = torch.zeros(8, 32, dtype=I8), torch.zeros(4, 32, dtype=I8), I8, False
    if case == "K * itemsize":
        a, bt = a[:, :24].contiguous(), bt[:, :24].contiguous()
    elif case == "mixed dtypes":
        bt = bt.to(BF16)
    elif case == "K mismatch":
        bt = torch.zeros(4, 48, dtype=I8)
    elif case == "3-D a":
        a = a[None]
    elif case == "bf16 to f32":
        a, bt, out = a.to(BF16), bt.to(BF16), F32
    elif case == "int8 dequant to int8":
        dq = True
    elif case == "bf16 dequant":
        a, bt, out, dq = a.to(BF16), bt.to(BF16), BF16, True
    else:
        a, bt, out = a.float(), bt.float(), F32
    with pytest.raises(ValueError, match=match):
        probes.matmul_route(a, bt, out, dq)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_quantizer_and_int8_dot_on_the_cpu_take_the_twins_and_count_no_launch(dtype):
    x = torch.randn(5, 7, 48).to(dtype)
    w = quant.colwise_int8(torch.randn(24, 48))
    counts = lambda: [(f.launches, dict(f.launches_by_shape))  # noqa: E731
                      for f in (quant.quantize_rows, quant.int8_dot)]
    before = counts()
    xq, s = quant.quantize_rows(x)
    assert torch.equal(xq, quant.rowwise_int8(x)[0]) and s.shape == (5, 7, 1)
    assert torch.equal(quant.int8_dot(x, w), quant.int8_dot_plain(x, w))
    assert counts() == before


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("k", [16, 48, 384, 1536, 4096])
def test_quantize_route_names_the_kernel(dtype, k):
    """Both input dtypes, K from one 16-byte step of int8 output to the
    widest row the kernel holds in registers, any number of rows."""
    assert quant.quantize_route(torch.zeros(3, 5, k, dtype=dtype)) == "quantize_rows.cu"


@pytest.mark.parametrize("case,match", [
    ("K not a multiple of 16", "multiple of 16"), ("K past QUANT_K_MAX", "multiple of 16"),
    ("int8 rows", "multiple of 16"), ("float64 rows", "multiple of 16"),
    ("a 0-d tensor", "multiple of 16"), ("misaligned view", "16-byte aligned"),
    ("strided view", "16-byte aligned")])
def test_quantize_route_raises_on_what_no_kernel_takes(case, match):
    """What the kernel cannot load raises ValueError, among it a contiguous
    view whose data is not 16-byte aligned (its 16-byte row loads would
    fault on the card)."""
    x = torch.zeros(4, 48)
    if case == "K not a multiple of 16":
        x = torch.zeros(4, 40)
    elif case == "K past QUANT_K_MAX":
        x = torch.zeros(1, quant.QUANT_K_MAX + 16)
    elif case == "int8 rows":
        x = x.to(I8)
    elif case == "float64 rows":
        x = x.double()
    elif case == "a 0-d tensor":
        x = torch.zeros(())
    elif case == "misaligned view":
        x = torch.zeros(4 * 48 + 1)[1:].view(4, 48)
        assert x.is_contiguous() and x.data_ptr() % 16
    else:
        x = torch.zeros(4, 96)[:, ::2]
    with pytest.raises(ValueError, match=match):
        quant.quantize_route(x)


@pytest.mark.parametrize("name", ["quantize_rows", "int8_dot"])
def test_int8_wrappers_raise_on_devices_without_a_kernel(name):
    x = torch.zeros(4, 48, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        if name == "quantize_rows":
            quant.quantize_rows(x)
        else:
            quant.int8_dot(x, (torch.zeros(8, 48, dtype=I8, device="meta"),
                               torch.zeros(8, device="meta")))


def _probe_inputs(variant, dtype=BF16, rows=130, keys=208, vstride=128, heads=2):
    """Zero operands of one probe_attention call: folded_t q (3, rows, 64),
    kt (3, 64, keys), v (3, keys, vstride); folded k and v (3, keys, 64);
    qkvflat (2, keys, 3 * heads * 64)."""
    layout = probes.VARIANTS[variant].layout
    bias = torch.zeros(keys)
    if layout == "qkvflat":
        return {"q": torch.zeros(2, keys, 3 * heads * 64, dtype=dtype), "bias": bias,
                "heads": heads}
    kshape = (3, 64, keys) if layout == "folded_t" else (3, keys, 64)
    return {"q": torch.zeros(3, rows, 64, dtype=dtype), "k": torch.zeros(kshape, dtype=dtype),
            "v": torch.zeros(3, keys, vstride if layout == "folded_t" else 64, dtype=dtype),
            "bias": bias}


@pytest.mark.parametrize("rows,keys", [(1, 64), (129, 208), (2312, 2432)])
@pytest.mark.parametrize("variant,dtype", [(v, BF16) for v in sorted(probes.VARIANTS)]
                         + [("dot", I8)])
def test_probe_attention_route_names_the_kernel(variant, dtype, rows, keys):
    """Every function of the probes, and probe_dot's int8 attention, at the
    kernel's tile edges and at the probes' shapes."""
    kw = _probe_inputs(variant, dtype, rows, keys)
    assert probes.probe_attention_route(variant, **kw) == "probe_attention_wgmma.cu"


@pytest.mark.parametrize("case,match", [
    ("int8 off dot", "int8 for 'dot' only"), ("mixed dtypes", "int8 for 'dot' only"),
    ("float64 bias", "float32 bias"), ("bias of the wrong length", "bias of 208"),
    ("folded_t keys not a multiple of 8", "multiple of 8"),
    ("int8 keys not a multiple of 16", "multiple of 16"), ("vstride under 64", ">= 64"),
    ("vstride misaligned", "multiple of 8"), ("int8 vstride misaligned", "multiple of 16"),
    ("qkv width not 3 heads 64", "qkv"), ("misaligned view", "16-byte aligned"),
    ("strided kt", "16-byte aligned"), ("unknown variant", "no variant")])
def test_probe_attention_route_raises_on_what_no_kernel_takes(case, match):
    """What the kernel's TMA maps cannot take raises ValueError, among it a
    contiguous view whose data is not 16-byte aligned."""
    variant, kw = "v0", _probe_inputs("v0")
    if case == "int8 off dot":
        kw = _probe_inputs("v0", I8)
    elif case == "mixed dtypes":
        kw["v"] = kw["v"].to(I8)
    elif case == "float64 bias":
        kw["bias"] = kw["bias"].double()
    elif case == "bias of the wrong length":
        kw["bias"] = torch.zeros(207)
    elif case == "folded_t keys not a multiple of 8":
        kw = _probe_inputs("v0", keys=204)
    elif case == "int8 keys not a multiple of 16":
        variant, kw = "dot", _probe_inputs("dot", I8, keys=200)
    elif case == "vstride under 64":
        kw = _probe_inputs("v0", vstride=56)
    elif case == "vstride misaligned":
        kw = _probe_inputs("v0", vstride=68)
    elif case == "int8 vstride misaligned":
        variant, kw = "dot", _probe_inputs("dot", I8, vstride=72)
    elif case == "qkv width not 3 heads 64":
        variant, kw = "qkvflat", _probe_inputs("qkvflat")
        kw["q"] = torch.zeros(2, 208, 3 * 2 * 64 + 8, dtype=BF16)
    elif case == "misaligned view":
        kw["q"] = torch.zeros(3 * 130 * 64 + 1, dtype=BF16)[1:].view(3, 130, 64)
        assert kw["q"].is_contiguous() and kw["q"].data_ptr() % 16
    elif case == "strided kt":
        kw["k"] = torch.zeros(3, 64, 416, dtype=BF16)[..., ::2]
    else:
        variant = "v1"
    with pytest.raises(ValueError, match=match):
        probes.probe_attention_route(variant, **kw)
