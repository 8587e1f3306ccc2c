"""Port parity for the LM serving slice: the FP4 KV-cache codec (K4/K5 plain
versions vs the interpret-mode Pallas kernels), rope, norms, MLPs,
attention decode, the W4 packing of LM weights, ``decode_step`` and the
launcher, each against the JAX package on the same numbers.

Tolerances:
  * K4/K5 and the kv4 oracles: bit-exact (packed bytes, f16 scale bits,
    decoded values' bits).
  * W4 packs of LM weights: byte-identical, scales equal.
  * rope, norms, activations, MLPs, attention decode: rtol = atol = 1e-5
    (f32; XLA's and torch's pow/cos/tanh differ by an ulp or two and the
    sums run in other orders).
  * decode_step, teacher-forced over packed W4 weights (the JAX side's
    stacked packs take its ``ref`` matmul, the port's slices K2's plain
    version: the same arithmetic up to the order of the f32 sums; which
    cases run W4A4 and why: the test's docstring and ROADMAP Queue C):
    f32, max abs error <= 1e-4 * max |logit| at every step and the same
    argmax; bf16, relative Frobenius error <= 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from _torch_decode import j_tree, k2_per_step
from _torch_parity import j_packed, np_tree, t, t_packed
from repro.configs.smollm_135m import smoke as j_smollm_smoke
from repro.configs.zamba2_27b import smoke as j_zamba2_smoke
from repro.kernels import ref as jref
from repro.launch.steps import make_decode_fn as j_make_decode_fn
from repro.launch.steps import quantize_lm_for_serving as j_quantize
from repro.models.lm import ATTN
from repro.models.lm import LMConfig as JLMConfig
from repro.models.lm import init_caches as j_init_caches
from repro.models.lm import lm_init as j_lm_init
from repro.nn import attention as jattn
from repro.nn import embeddings as jemb
from repro.nn import layers as jlayers
from repro.nn import mlp as jmlp
from repro.quant.calibrate import QuantContext as JCtx
from repro.quant.fakequant import QuantizerParams as JQP
from repro_torch.common.tree import flatten_paths
from repro_torch.convert import from_numpy_tree
from repro_torch.core.qmodule import PackedW4, dequant_weight
from repro_torch.kernels import kv4 as tkv4
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                      quantize_lm_for_serving)
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tattn
from repro_torch.nn import embeddings as temb
from repro_torch.nn import layers as tlayers
from repro_torch.nn import mlp as tmlp
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams

TOL = dict(rtol=1e-5, atol=1e-5)
TDTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture
def jax_interpret():
    """The JAX package's Pallas kernels in interpret mode (on the CPU its
    kv4 dispatch otherwise takes the ref.py oracles)."""
    old = jops.FORCE
    jops.FORCE = "interpret"
    yield
    jops.FORCE = old


def _bits(x) -> np.ndarray:
    """The bits of an f32/bf16/f16 array or tensor, for exact comparison
    (-0.0 differs from 0.0)."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    else:
        x = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                       else x)
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint16)


def _kv_input(shape, seed):
    """Rows of mixed magnitude with a zero row, -0.0 entries and a row of
    exact grid midpoints (absmax 6, so |t| * 6 / 6 hits 0.25, 0.75, ...)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x *= rng.uniform(0.01, 20.0, size=(*shape[:-1], 1)).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    if flat.shape[0] > 1:
        flat[1, :3] = -0.0
    if flat.shape[0] > 2:
        mids = np.array([6.0, 0.25, -0.75, 1.25, -1.75, 2.5, -3.5, 5.0],
                        np.float32)
        flat[2] = np.resize(mids, shape[-1])
    return flat.reshape(shape)


KV_SHAPES = [(16, 64), (3, 5, 8, 128), (1, 1, 2, 64), (300, 64)]


@pytest.mark.parametrize("shape", KV_SHAPES)
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_kv4_plain_bit_exact_with_interpret_kernels(shape, dt, jax_interpret):
    x = jnp.asarray(_kv_input(shape, 0)).astype(dt)
    jp, js = jops.kv4_encode(x)
    tp, ts = tops.kv4_encode(t(x.astype(jnp.float32)).to(TDTYPE[dt]))
    assert tp.shape == jp.shape and ts.shape == js.shape
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(ts), _bits(np.asarray(js)))
    for odt in (jnp.float32, jnp.bfloat16):
        jo = jops.kv4_decode(jp, js, odt)
        to = tops.kv4_decode(tp, ts, TDTYPE[odt])
        assert to.dtype == TDTYPE[odt] and to.shape == jo.shape
        np.testing.assert_array_equal(_bits(to), _bits(jo))


def test_kv4_ops_route_plain_on_cpu():
    tops.reset_routes()
    p, s = tops.kv4_encode(torch.ones(2, 3, 16))
    tops.kv4_decode(p, s, torch.float32)
    assert dict(tops.ROUTES) == {("kv4_encode", "plain"): 1,
                                 ("kv4_decode", "plain"): 1}
    with pytest.raises(ValueError, match="even"):
        tkv4.kv4_encode_2d(torch.ones(2, 7))


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
def test_kv4_ref_oracles_match_reference(dt):
    """The ported eager oracles equal the reference's bit for bit (they are
    not what the kernels compute: ROADMAP Queue C)."""
    x = jnp.asarray(_kv_input((40, 32), 1)).astype(dt)
    jp, js = jref.ref_kv4_encode(x)
    tp, ts = tref.ref_kv4_encode(t(x.astype(jnp.float32)).to(TDTYPE[dt]))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(ts), _bits(np.asarray(js)))
    jo = jref.ref_kv4_decode(jp, js, jnp.float32)
    to = tref.ref_kv4_decode(tp, ts, torch.float32)
    np.testing.assert_array_equal(_bits(to), _bits(jo))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rope_matches():
    rng = np.random.default_rng(2)
    jc, js = jemb.rope_frequencies(16, 12, 10_000.0)
    tc, ts = temb.rope_frequencies(16, 12, 10_000.0)
    torch.testing.assert_close(tc, t(jc), **TOL)
    torch.testing.assert_close(ts, t(js), **TOL)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    want = jemb.apply_rope(jnp.asarray(x), jc, js)
    got = temb.apply_rope(t(x), tc, ts)
    torch.testing.assert_close(got, t(want), **TOL)
    # bf16 acts: rotated in f32, cast back
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jemb.apply_rope(xb, jc, js)
    got = temb.apply_rope(t(xb.astype(jnp.float32)).bfloat16(), tc, ts)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), t(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("plus_one", [False, True])
def test_norms_match(plus_one):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3, 24)).astype(np.float32) * 3
    g = rng.normal(size=(24,)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jlayers.rmsnorm_apply({"g": jnp.asarray(g)}, jnp.asarray(x),
                                 plus_one=plus_one)
    got = tlayers.rmsnorm_apply({"g": t(g)}, t(x), plus_one=plus_one)
    torch.testing.assert_close(got, t(want), **TOL)
    want = jlayers.layernorm_apply({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                                   jnp.asarray(x))
    got = tlayers.layernorm_apply({"g": t(g), "b": t(b)}, t(x))
    torch.testing.assert_close(got, t(want), **TOL)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh", "relu"])
def test_activations_match(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    want = jlayers.ACTIVATIONS[name](jnp.asarray(x))
    torch.testing.assert_close(tlayers.ACTIVATIONS[name](t(x)), t(want),
                               **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(kind):
    jp = jmlp.mlp_init(jax.random.PRNGKey(4), 16, 40, kind)
    x = np.random.default_rng(4).normal(size=(3, 1, 16)).astype(np.float32)
    want = jmlp.mlp_apply(jp, jnp.asarray(x), kind, site="mlp")
    got = tmlp.mlp_apply(from_numpy_tree(np_tree(jp), "cpu"), t(x), kind,
                         site="mlp")
    torch.testing.assert_close(got, t(want), **TOL)


def test_fp8_cast_follows_jax_past_448():
    x = np.array([447, 448, 449, 464, 465, 500, -470, np.inf, 1e-3, 0.0],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    got = tattn.to_fp8_e4m3(t(x)).float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("kv", ["bf16", "fp8", "fp4"])
def test_attn_decode_matches(kv, jax_interpret):
    """A few decode steps of one attention layer from an empty cache, on
    dense f32 weights with a qkv bias."""
    jcfg = jattn.AttnConfig(32, 4, 2, 8, qkv_bias=True)
    tcfg = tattn.AttnConfig(32, 4, 2, 8, qkv_bias=True)
    jp = jattn.attn_init(jax.random.PRNGKey(5), jcfg)
    jp = jax.tree.map(lambda a: a + 0.1, jp)    # non-zero biases
    tp = from_numpy_tree(np_tree(jp), "cpu")
    jc = jattn.init_kv_cache(2, 6, jcfg, kv)
    tc = tattn.init_kv_cache(2, 6, tcfg, kv)
    xs = np.random.default_rng(5).normal(size=(4, 2, 1, 32)).astype(np.float32)
    step = jax.jit(lambda c, x, cos, sin, i: jattn.attn_decode(
        jp, x, c, i, i + 1, cos, sin, jcfg, kv_dtype=kv, site="a"))
    for i in range(4):
        ang = i * (1.0 / (10_000.0 ** (np.arange(0, 8, 2) / 8)))
        cos = np.cos(ang)[None].astype(np.float32)
        sin = np.sin(ang)[None].astype(np.float32)
        want, jc = step(jc, jnp.asarray(xs[i]), jnp.asarray(cos),
                        jnp.asarray(sin), jnp.int32(i))
        got, tc = tattn.attn_decode(tp, t(xs[i]), tc, i, i + 1, t(cos),
                                    t(sin), tcfg, kv_dtype=kv, site="a")
        torch.testing.assert_close(got, t(want), **TOL)
    if kv == "fp4":     # the K4 writes landed byte for byte
        np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
        np.testing.assert_array_equal(tc["v"].numpy(), np.asarray(jc["v"]))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

J_DENSE = JLMConfig("t", n_layers=3, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                    vocab=97, qkv_bias=True, dtype=jnp.float32, q_chunk=4)
# every other dense-family branch: ring slots, scale_embed, sinusoidal
# positions, the logit softcap, GeGLU, untied head
J_MIXED = JLMConfig("m", n_layers=4, d_model=32, n_heads=4, n_kv=2, d_ff=64,
                    vocab=61, mlp_kind="geglu", pos="sinusoidal",
                    scale_embed=True, logits_softcap=30.0,
                    layer_pattern=((ATTN, 3, 10_000.0), (ATTN, None, 1e6)),
                    dtype=jnp.float32, q_chunk=4)
J_CONFIGS = {"smollm-smoke": j_smollm_smoke(), "dense-qkv-bias": J_DENSE,
             "mixed": J_MIXED}


def t_config(jcfg, **kw) -> tlm.LMConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tlm.LMConfig)}
    fields["dtype"] = TDTYPE[jcfg.dtype]
    fields.update(kw)
    return tlm.LMConfig(**fields)


def _params(jcfg, seed=0):
    jp = j_lm_init(jax.random.PRNGKey(seed), jcfg)
    return jp, from_numpy_tree(np_tree(jp), "cpu")


def test_lm_init_layout_matches_reference():
    jcfg = J_MIXED
    jp, _ = _params(jcfg)
    tp = tlm.lm_init(torch.Generator().manual_seed(0), t_config(jcfg))
    jflat = {k: v for k, v in flatten_paths(np_tree(jp)).items()}
    tflat = flatten_paths(tp)
    assert sorted(jflat) == sorted(tflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
    spec = tlm.cache_specs(t_config(jcfg), 2, 8)["blocks"]
    assert spec[0]["k"]["shape"] == (2, 2, 3, 2, 8)   # ring of window 3
    assert spec[1]["k"]["shape"] == (2, 2, 8, 2, 8)


# each family's branch on a config beside J_DENSE (the cases that raised
# NotImplementedError before the families were ported)
FAMILY_KW = [
    dict(family="moe", d_ff=0, n_experts=4, top_k=2, moe_d_ff=32,
         n_shared=1),
    dict(family="ssm", d_ff=0, layer_pattern=(("ssm", None, 10_000.0),),
         ssm_d_state=16, ssm_headdim=16, tie_embeddings=True),
    dict(family="vlm", n_img_tokens=4, d_vision=24),
    dict(family="audio", pos="sinusoidal", mlp_kind="gelu"),
    dict(family="hybrid", shared_attn_every=3, ssm_d_state=16,
         ssm_headdim=16, layer_pattern=(("ssm", None, 10_000.0),) * 3),
    dict(layer_pattern=(("ssm", None, 10_000.0), (ATTN, 4, 10_000.0),
                        (ATTN, None, 1e6)), ssm_d_state=16, ssm_headdim=16),
    dict(first_k_dense=1, n_layers=4)]


@pytest.mark.parametrize("kw", FAMILY_KW)
def test_unported_families_raise(kw):
    """(The name is kept from the refusal this test held before the
    families were ported.) Each family decodes 6 steps on the CPU from
    its packed W4A4 weights through the plain versions: finite logits,
    every dense site on K2's plain version (4 an attention layer, 3 a
    GLU MLP, 2 a GELU one or an SSM layer, 3 a shared expert), every
    expert product weight-only (3 an expert), the KV kernels once an
    attention layer, no oracle."""
    cfg = dataclasses.replace(t_config(J_DENSE, **kw), kv_dtype="fp4")
    p = quantize_lm_for_serving(tlm.lm_init(torch.Generator().manual_seed(1),
                                            cfg), searched=False)
    ctx = QuantContext("serve", act_qps={"*": QuantizerParams(
        0, 2, 1, 4, torch.tensor(6.0))})
    step = make_decode_fn(cfg, ctx=ctx)
    caches = tlm.init_caches(cfg, 2, 6)
    tops.reset_routes()
    for i in range(6):
        lg, caches = step(p, caches, torch.full((2, 1), i % cfg.vocab), i)
        assert lg.shape == (2, 1, cfg.vocab)
        assert bool(torch.isfinite(lg).all())
    dense, expert = k2_per_step(cfg)
    n_attn = cfg.first_k_dense + cfg.n_groups * (
        sum(k == ATTN for k, _, _ in cfg.layer_pattern)
        + bool(cfg.shared_attn_every))
    routes = dict(tops.ROUTES)
    assert routes.pop(("w4a4_matmul", "plain")) == 6 * dense
    assert routes.pop(("w4_matmul", "plain"), 0) == 6 * expert
    assert routes.pop(("kv4_store", "plain"), 0) == 6 * n_attn
    assert routes.pop(("kv4_attend", "plain"), 0) == 6 * n_attn
    assert "ref" not in {r for (_, r) in routes}, routes


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_lm_bytes_match_reference(dt, per_channel):
    jcfg = dataclasses.replace(J_DENSE, dtype=dt)
    jp, tp = _params(jcfg, seed=1)
    jq = flatten_paths(j_quantize(jp, searched=False,
                                  per_channel=per_channel))
    tq = flatten_paths(quantize_lm_for_serving(tp, per_channel=per_channel,
                                               searched=False))
    assert sorted(jq) == sorted(tq)
    n_packed = 0
    for k, want in jq.items():
        got = tq[k]
        if not isinstance(got, PackedW4):
            assert not hasattr(want, "packed"), k
            continue
        n_packed += 1
        ref = t_packed(want)
        np.testing.assert_array_equal(got.packed.numpy(), ref.packed.numpy())
        np.testing.assert_array_equal(got.scale.numpy(), ref.scale.numpy())
        np.testing.assert_array_equal(got.zero_point.numpy(),
                                      ref.zero_point.numpy())
        assert got.shape == tuple(want.shape)
    assert n_packed == 7       # wq wk wv wo gate up down, stacked


def test_quantize_lm_searched_raises():
    """(The name is kept from the refusal this test held before the search
    was ported.) ``searched=True`` on zamba2's smoke config, per channel:
    each unscanned 2D weight (the shared block's) through the MSE search,
    its format, maxvals and bytes the reference's; each stacked weight on
    absmax scales whatever ``searched`` says, as the reference does."""
    jcfg = j_zamba2_smoke()
    tp = tlm.lm_init(torch.Generator().manual_seed(1), t_config(jcfg))
    jq = flatten_paths(j_quantize(j_tree(tp), searched=True,
                                  per_channel=True))
    tq = flatten_paths(quantize_lm_for_serving(tp, searched=True,
                                               per_channel=True))
    assert sorted(jq) == sorted(tq)
    n_searched = n_stacked = 0
    for k, want in jq.items():
        got = tq[k]
        if not isinstance(got, PackedW4):
            assert not hasattr(want, "packed"), k
            continue
        ref = t_packed(want)
        assert (got.exp_bits, got.man_bits, got.signed) == \
            (ref.exp_bits, ref.man_bits, ref.signed), k
        np.testing.assert_array_equal(got.packed.numpy(), ref.packed.numpy())
        np.testing.assert_array_equal(got.scale.numpy(), ref.scale.numpy())
        np.testing.assert_array_equal(got.zero_point.numpy(),
                                      ref.zero_point.numpy())
        if got.packed.ndim == 2:
            n_searched += 1
        else:
            n_stacked += 1
            assert (got.exp_bits, got.man_bits) == (2, 1), k
    assert (n_searched, n_stacked) == (6, 4)


def test_quantize_lm_default_is_searched():
    """Both packages' default is ``searched=True``: on zamba2's smoke
    config each side's default packs equal its own ``searched=True``
    packs byte for byte, and the port's default equals the reference's
    default."""
    tp = tlm.lm_init(torch.Generator().manual_seed(2),
                     t_config(j_zamba2_smoke()))
    jp = j_tree(tp)
    j_def, j_on = (flatten_paths(q) for q in (
        j_quantize(jp), j_quantize(jp, searched=True)))
    t_def, t_on = (flatten_paths(q) for q in (
        quantize_lm_for_serving(tp),
        quantize_lm_for_serving(tp, searched=True)))
    assert sorted(j_def) == sorted(t_def) == sorted(t_on)
    n_searched = 0
    for k, want in j_def.items():
        if not hasattr(want, "packed"):
            continue
        got, on, ref, j_ref = (t_def[k], t_on[k], t_packed(want),
                               t_packed(j_on[k]))
        for a, b in ((got, on), (got, ref), (ref, j_ref)):
            assert (a.exp_bits, a.man_bits, a.signed) == \
                (b.exp_bits, b.man_bits, b.signed), k
            for f in ("packed", "scale", "zero_point"):
                assert torch.equal(getattr(a, f), getattr(b, f)), (k, f)
        n_searched += got.packed.ndim == 2
    assert n_searched == 6


@pytest.mark.parametrize("per_channel", [False, True])
def test_slice_gives_each_layer_its_own_pack_and_scale(per_channel):
    """``dyadic_weights`` sets layer g's output column n to absmax
    0.75 * 2^-(g % 3 + n % 4); ``lm._slice`` hands layer g a 2D pack with
    that layer's scale, a scalar per tensor or (N,) per channel, whose
    decode is layer g of the stacked weight's decode."""
    cfg = t_config(J_DENSE)
    tp = quantize_lm_for_serving(dyadic_weights(tlm.lm_init(
        torch.Generator().manual_seed(3), cfg)), per_channel=per_channel,
        searched=False)
    stack = tp["blocks"][0]["attn"]["wv"]["w"]
    g_n, n = stack.shape[0], stack.shape[-1]
    col = torch.arange(n) % 4
    for g in range(g_n):
        pw = tlm._slice(tp["blocks"][0], g)["attn"]["wv"]["w"]
        assert isinstance(pw, PackedW4) and pw.packed.ndim == 2
        assert pw.shape == tuple(stack.shape[1:])
        want = 0.75 * torch.exp2(-(g % 3 + col * per_channel).float())
        if not per_channel:
            want = want[0]
        assert tuple(pw.scale.shape) == ((n,) if per_channel else ())
        torch.testing.assert_close(pw.scale, want, rtol=0, atol=0)
        torch.testing.assert_close(
            dequant_weight(pw, torch.float32),
            dequant_weight(stack, torch.float32)[g], rtol=0, atol=0)


DECODE_CASES = [  # (config, dtype, kv, per-channel W4, fp4 acts, dyadic)
    ("smollm-smoke", jnp.float32, "fp4", False, True, True),
    ("smollm-smoke", jnp.float32, "bf16", True, True, True),
    ("dense-qkv-bias", jnp.float32, "fp4", True, True, True),
    ("mixed", jnp.float32, "fp4", False, True, True),
    ("smollm-smoke", jnp.float32, "fp8", False, False, False),
    ("mixed", jnp.float32, "fp8", True, False, False),
    ("smollm-smoke", jnp.bfloat16, "bf16", False, False, False),
    ("dense-qkv-bias", jnp.bfloat16, "bf16", True, False, False),
]


@pytest.mark.parametrize("name,dt,kv,pc,act,dy", DECODE_CASES)
def test_decode_step_teacher_forced_matches(name, dt, kv, pc, act, dy,
                                            jax_interpret):
    """W4 weights (per tensor or per channel), optionally E2M1 acts fused
    into the matmuls, the given KV cache: 8 teacher-forced steps from an
    empty cache, each side carrying its own cache.

    W4A4 runs on ``steps.dyadic_weights`` (exact sums in any order; on
    generic weights the order of the sums decides FP4 and act-grid ties,
    so the comparison would measure it) with FP4 and bf16 caches. An FP8
    cache holds so few distinct values that an attention output often
    equals a cached value, and so an act-grid midpoint, up to the last ulp
    of the softmax sum: those cases run W4 with acts off. bf16 models run
    W4 with acts off and a bf16 cache: XLA's CPU bf16 arithmetic (its bf16
    sigmoid rounds otherwise than torch's, and it keeps f32 between fused
    ops) moves the snapped acts and FP4 codes off the port's
    (``_torch_lm_survey.py``)."""
    jcfg = dataclasses.replace(J_CONFIGS[name], dtype=dt, kv_dtype=kv)
    tcfg = t_config(jcfg)
    # the port's seeded init and packs, handed to the reference: both
    # layouts and pack bytes are held identical by the tests above, and
    # this costs no eager JAX compiles
    tp = tlm.lm_init(torch.Generator().manual_seed(2), tcfg)
    if dy:
        tp = dyadic_weights(tp)
    tp = quantize_lm_for_serving(tp, per_channel=pc, searched=False)
    jp = jax.tree.map(
        lambda v: j_packed(v) if isinstance(v, PackedW4)
        else jnp.asarray(v.float().numpy()).astype(dt), tp,
        is_leaf=lambda v: isinstance(v, PackedW4))
    jctx = tctx = None
    if act:
        jctx = JCtx("serve", act_qps={"*": JQP(0, 2, 1, 4, jnp.float32(6.0))})
        tctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0))})
    b, steps = 2, 8
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (b, steps))
    jstep = jax.jit(j_make_decode_fn(jcfg, ctx=jctx))
    tstep = make_decode_fn(tcfg, ctx=tctx)
    jc = j_init_caches(jcfg, b, steps)
    tc = tlm.init_caches(tcfg, b, steps)
    tops.reset_routes()
    want, got = [], []
    for i in range(steps):
        tok = toks[:, i:i + 1].astype(np.int32)
        lg, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(i))
        want.append(np.asarray(lg.astype(jnp.float32)))
        lg, tc = tstep(tp, tc, torch.from_numpy(tok).long(), i)
        got.append(lg.float().numpy())
    want, got = np.stack(want), np.stack(got)
    assert got.shape == (steps, b, 1, jcfg.vocab)
    assert np.isfinite(got).all()
    # every packed site runs K2's plain version, never the stacked oracle
    assert "ref" not in {r for (_, r) in tops.ROUTES}, dict(tops.ROUTES)
    assert tops.ROUTES[("w4a4_matmul" if act else "w4_matmul", "plain")] \
        == 7 * jcfg.n_layers * steps
    if dt == jnp.float32:
        scale = np.abs(want).max(axis=(1, 2, 3))
        err = np.abs(got - want).max(axis=(1, 2, 3))
        assert (err <= 1e-4 * scale).all(), err / scale
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 2e-2, rel


def test_launcher_cpu_smoke_takes_plain_routes_only():
    tops.reset_routes()
    out = tserve.main(["--arch", "smollm-135m", "--smoke", "--quant", "w4",
                       "--act-quant", "fp4", "--kv", "fp4", "--batch", "2",
                       "--prompt-len", "3", "--gen-len", "3",
                       "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    n_layers = j_smollm_smoke().n_layers
    steps = 3 + 3
    assert dict(tops.ROUTES) == {
        ("w4a4_matmul", "plain"): 7 * n_layers * steps,
        ("kv4_store", "plain"): n_layers * steps,
        ("kv4_attend", "plain"): n_layers * steps,
        ("tied_logits", "torch"): steps}
    assert set(out["launches_per_step"].values()) == {0}


def test_launcher_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        tserve.main(["--arch", "smollm-135m", "--smoke", "--device", "cuda"])


def test_from_numpy_tree_carries_bf16_bits():
    x = jnp.asarray(np.random.default_rng(7).normal(size=(5, 3))
                    .astype(np.float32)).astype(jnp.bfloat16)
    got = from_numpy_tree({"a": [np.asarray(x)]}, "cpu")["a"][0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(x))
