"""The port's probe kernels' plain twins (ops/probes.py) against the TPU
probes of tools/, whose Pallas bodies run here in interpret mode, and the
port's probe CLIs at a tiny size on the CPU."""

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from vit_ocm_wmsegmentation_tpu_torch.ops import probes
from vit_ocm_wmsegmentation_tpu_torch.tools import bench_attention_variants as tbav
from vit_ocm_wmsegmentation_tpu_torch.tools import bench_attn_opt as tbao
from vit_ocm_wmsegmentation_tpu_torch.tools import probe_dot as tpd

from port_helpers import one_torch_thread  # noqa: F401  (autouse)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
# bench_attn_opt's globals shrunk for the CPU; D stays 64
SMALL = {"B": 1, "H": 2, "N": 200, "NP": 256, "BQ": 200, "DM": 128, "QKV_COLS": 384}
TOL = 1e-2  # max|d| / max|TPU body| in bf16: one-ulp flips of rounded P and outputs


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """The TPU probes' pallas_call in interpret mode, on the CPU."""
    monkeypatch.setattr(jpl, "pallas_call", functools.partial(jpl.pallas_call, interpret=True))


@pytest.fixture
def attn_opt(interpret, monkeypatch):
    """tools/bench_attn_opt.py at SMALL, with the compilation-cache settings
    its import changes restored."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        mod = _load("bench_attn_opt")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    for name, value in SMALL.items():
        monkeypatch.setattr(mod, name, value)
    return mod


def _t(x):
    return torch.from_numpy(np.asarray(jnp.asarray(x, jnp.float32))).to(torch.bfloat16)


def _close(got, want):
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


def _bias(mod):
    return torch.where(torch.arange(mod.NP) < mod.N, 0.0, -1e30).float()


def _jax_case(mod, which):
    """(JAX output, the port's probe_attention_plain keyword arguments on the
    same inputs) for one of bench_attn_opt's variants, as its main() runs it."""
    use_exp2 = which in ("exp2", "split2", "split4", "stagger2", "stagger4", "stagger8", "bf16sm")
    expfn = jnp.exp2 if use_exp2 else jnp.exp
    if which == "combo":
        run, (q,) = mod.run_combo()
        kw = tbao.inputs("combo", "cpu", 1, 2, 200)
        assert torch.equal(kw["q"], _t(q))
        return run(q), kw
    if which.startswith("qkvflat"):
        run, (qkv,) = {"qkvflat": mod.run_qkvflat, "qkvflat_pipe": mod.run_qkvflat_pipe,
                       "qkvflat_pipe2": functools.partial(mod.run_qkvflat_pipe, expfn=jnp.exp2),
                       "qkvflat_pipe2b": functools.partial(mod.run_qkvflat_pipe, expfn=jnp.exp2,
                                                           sm_bf16=True)}[which]()
        return run(qkv), {"q": _t(qkv), "bias": _bias(mod), "heads": mod.H}
    kern = {"v0": functools.partial(mod.kern_base, expfn=jnp.exp),
            "grid2": functools.partial(mod.kern_base, expfn=jnp.exp),
            "exp2": functools.partial(mod.kern_base, expfn=jnp.exp2),
            "nomax": mod.kern_nomax, "normbound": mod.kern_normbound, "bf16sm": mod.kern_bf16sm,
            "split2": functools.partial(mod.kern_split, ways=2, expfn=expfn),
            "split4": functools.partial(mod.kern_split, ways=4, expfn=expfn)}.get(which)
    if which.startswith("stagger"):
        kern = functools.partial(mod.kern_stagger, ways=int(which[len("stagger"):]),
                                 expfn=jnp.exp2)
    run, n_rows = mod.pallas_run(kern, nq_blocks=2 if which == "grid2" else 1)
    q, kt, ve, bias = mod.make_inputs(use_exp2, q_rows=n_rows)
    kw = {"q": _t(q), "k": _t(kt), "v": _t(ve), "bias": torch.from_numpy(np.asarray(bias[0]))}
    return run(q, kt, ve, bias), kw


@pytest.mark.parametrize("which", list(tbao.VARIANTS))
def test_bench_attn_opt_variants_match_the_tpu_bodies(attn_opt, which):
    out, kw = _jax_case(attn_opt, which)
    _close(probes.probe_attention_plain(tbao.VARIANTS[which], **kw), out)


# the card kernel's tile edges: 128 query rows a CTA, 64 keys a tile
EDGE_ROWS, EDGE_KEYS = (1, 127, 128, 129), (63, 65, 129)


def _at_edges(mod, monkeypatch, rows, keys):
    """bench_attn_opt's globals at `rows` query rows and `keys` keys, the
    last 5 padded at -1e30."""
    for name, value in {"N": keys - 5, "NP": keys, "BQ": rows}.items():
        monkeypatch.setattr(mod, name, value)


@pytest.mark.parametrize("keys", EDGE_KEYS)
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("which", ["v0", "normbound", "combo"])
def test_bench_attn_opt_variants_match_the_tpu_bodies_at_tile_edges(attn_opt, monkeypatch,
                                                                    which, rows, keys):
    """The twins of a two-pass (row max), a one-pass (Cauchy-Schwarz) and the
    folded function against the TPU bodies at the card kernel's tile edges."""
    _at_edges(attn_opt, monkeypatch, rows, keys)
    if which != "combo":
        out, kw = _jax_case(attn_opt, which)
    else:  # run_combo's own draws, in its order
        run, (q,) = attn_opt.run_combo()
        rng = np.random.default_rng(0)
        g, d = attn_opt.B * attn_opt.H, attn_opt.D
        rng.normal(0, 1, (g, rows, d))
        k, v = (_t(jnp.asarray(rng.normal(0, 1, (g, keys, d)), jnp.bfloat16)) for _ in range(2))
        out, kw = run(q), {"q": _t(q), "k": k, "v": v, "bias": _bias(attn_opt)}
    assert kw["q"].shape[1] == rows and kw["bias"].shape == (keys,)
    _close(probes.probe_attention_plain(tbao.VARIANTS[which], **kw), out)


@pytest.mark.parametrize("keys", EDGE_KEYS)
def test_qkvflat_matches_the_tpu_body_at_tile_edges(attn_opt, monkeypatch, keys):
    """qkvflat, whose query rows are its keys, at the kernel's key-tile edges."""
    _at_edges(attn_opt, monkeypatch, keys, keys)
    out, kw = _jax_case(attn_opt, "qkvflat")
    assert kw["q"].shape[1] == keys
    _close(probes.probe_attention_plain(tbao.VARIANTS["qkvflat"], **kw), out)


@pytest.mark.parametrize("function", ["v0", "exp2", "bf16sm", "qkvflat_pipe2"])
def test_bench_attn_opt_inputs_are_the_originals(attn_opt, function):
    """The port's CLI draws the original's inputs (same seed, same order)."""
    kw = tbao.inputs(function, "cpu", 1, 2, 200)
    if function.startswith("qkvflat"):
        _, (qkv,) = attn_opt.run_qkvflat_pipe(expfn=jnp.exp2)
        assert torch.equal(kw["q"], _t(qkv))
        return
    q, kt, ve, bias = attn_opt.make_inputs(function != "v0", q_rows=attn_opt.BQ)
    for got, want in ((kw["q"], q), (kw["k"], kt), (kw["v"], ve)):
        assert torch.equal(got, _t(want))
    assert torch.equal(kw["bias"], torch.from_numpy(np.asarray(bias[0])))


@pytest.mark.parametrize("mode", tbav.MODES)
def test_attention_variant_modes_match_the_tpu_body(interpret, mode):
    mod = _load("bench_attention_variants")
    b, h, n, d = 1, 2, 200, 64
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(0, 1, (b, h, n, d)), jnp.bfloat16) for _ in range(3))
    want = mod.make_variant(mode, 128)(q, k, v)
    qf, kt, vf, bias, scale = tbav.folded_inputs(b, h, n, "cpu")
    assert torch.equal(qf, _t(q).reshape(b * h, n, d))
    got = probes.probe_attention_plain(mode, qf, kt, vf, bias, scale).reshape(b, h, n, d)
    _close(got, want)


def test_xla_conversions_the_probes_rely_on():
    """int32 -> int8 wraps, f32 -> int8 truncates toward zero, int32 -> f32
    rounds to nearest even: XLA's converts and the port's twins agree."""
    wrapped = np.asarray(jnp.int32(np.array([300, -200, 128, -129])).astype(jnp.int8))
    assert wrapped.tolist() == [44, 56, -128, 127]
    assert probes._wrap_int8(torch.tensor([300, -200, 128, -129])).tolist() == wrapped.tolist()
    trunc = np.asarray((jnp.float32(np.array([0.999, 0.5, 1.0])) * 127.0).astype(jnp.int8))
    assert trunc.tolist() == [126, 63, 127]
    assert torch.trunc(torch.tensor([0.999, 0.5, 1.0]) * 127.0).to(torch.int8).tolist() == [126, 63, 127]
    big = float(np.asarray(jnp.int32(16777217).astype(jnp.float32)))
    assert big == 16777216.0
    # the plain product rounds its exact integer sum the same way
    a = torch.tensor([[127] * 16], dtype=torch.int8)
    b = torch.ones((16, 1), dtype=torch.int8)
    assert float(probes.exact_product(a, b)) == 2032.0
    assert float(torch.tensor(16777217, dtype=torch.int64).float()) == big


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_probe_matmul_matches_the_tpu_body(dtype):
    """probe_dot's `kern` (:38-41) restated in jnp at M = K = N = 64; int8
    values span [-127, 127], so the int32 sums wrap on the int8 store."""
    rng = np.random.default_rng(3)
    if dtype == "int8":
        a, b = rng.integers(-127, 128, (64, 64)), rng.integers(-127, 128, (64, 64))
        ja, jb, jt, acc = jnp.asarray(a, jnp.int8), jnp.asarray(b, jnp.int8), jnp.int8, jnp.int32
        ta, tbt = torch.from_numpy(a).to(torch.int8), torch.from_numpy(b.T.copy()).to(torch.int8)
    else:
        a, b = rng.normal(0, 0.1, (64, 64)), rng.normal(0, 0.1, (64, 64))
        ja, jb, jt, acc = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), jnp.bfloat16, jnp.float32
        ta, tbt = _t(ja), _t(jb).T.contiguous()
    want = jax.lax.dot_general(ja, jb, (((1,), (0,)), ((), ())),
                               preferred_element_type=acc).astype(jt)
    got = probes.probe_matmul(ta, tbt)
    if dtype == "int8":
        assert (np.abs(np.asarray(want, np.int32)) > 0).any()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want)


def _jnp_attn(q, kt, v, bias, int8):
    """probe_dot's attention `kern` (:72-84) in jnp, one group at a time."""
    acc = jnp.int32 if int8 else jnp.float32
    outs = []
    for g in range(q.shape[0]):
        s = jax.lax.dot_general(q[g], kt[g], (((1,), (0,)), ((), ())),
                                preferred_element_type=acc).astype(jnp.float32)
        s = s * (1.0 / 16.0) + bias
        p = jnp.exp(s - jnp.max(s, axis=-1, keepdims=True))
        pq = (p * 127.0).astype(jnp.int8) if int8 else p.astype(jnp.bfloat16)
        oe = jax.lax.dot_general(pq, v[g], (((1,), (0,)), ((), ())),
                                 preferred_element_type=acc).astype(jnp.float32)
        outs.append(oe[:, :64].astype(jnp.bfloat16))
    return jnp.stack(outs)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_probe_attention_matches_the_tpu_body(dtype):
    q, kt, v, bias = tpd.attn_inputs(dtype, 2, 256, "cpu")
    int8 = dtype == torch.int8
    conv = (lambda x: jnp.asarray(x.numpy(), jnp.int8)) if int8 else (
        lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16))
    want = _jnp_attn(conv(q), conv(kt), conv(v), jnp.asarray(bias.numpy()), int8)
    got = probes.probe_attention("dot", q, kt, v, bias, 1.0 / 16.0)
    _close(got, want)


def test_probe_clis_run_on_the_cpu(capsys):
    for which in tpd.MODES:
        tpd.main([which, "--device", "cpu", "--mm_size", "64", "--attn_shape", "2", "200", "256"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all("max|d| 0.000e+00" in ln and "launches 0" in ln for ln in lines)
    tbav.main(["--device", "cpu", "--shape", "1", "2", "72", "--modes", "full", "noexp"])
    assert len(capsys.readouterr().out.splitlines()) == 2 * len(tbav.BLOCK_Q)
    tbao.main(["split2", "v0", "qkvflat_pipe", "--device", "cpu", "--shape", "1", "2", "72"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["function"] for r in rows] == ["exp2", "v0", "qkvflat"]
    assert rows[0]["note"] and "note" not in rows[1] and rows[0]["ms"] is None


def test_probe_wrappers_raise_off_cpu_without_kernel():
    """A tensor neither on the CPU nor on a CUDA device has no kernel: the new
    wrappers raise rather than take their twins."""
    from vit_ocm_wmsegmentation_tpu_torch.ops import quant

    meta = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        probes.probe_matmul(meta(4, 32, dtype=torch.int8), meta(8, 32, dtype=torch.int8))
    with pytest.raises(ValueError, match="no kernel"):
        probes.probe_attention("v0", meta(1, 8, 64, dtype=torch.bfloat16),
                               meta(1, 64, 64, dtype=torch.bfloat16),
                               meta(1, 64, 64, dtype=torch.bfloat16), meta(64))
    with pytest.raises(ValueError, match="no kernel"):
        quant.int8_dot(meta(4, 64), meta(8, 64))
    assert probes.probe_matmul.launches == probes.probe_attention.launches == 0
    assert quant.int8_dot.launches == 0
