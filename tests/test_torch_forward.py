"""Port parity for the LM full-sequence forward (prefill and training):
``attn_apply`` and its mask, the SSD pieces (``_causal_conv``,
``_segsum``, ``ssd_scan``, ``ssm_apply``), ``aux_load_balance_loss``,
``forward`` and ``loss_fn`` for every arch of the registry,
``make_prefill_step`` on W4 packs (K2's weight-only mode) and ``forward``
under a serve context (W4A4 K2, K1 before an untied head) against the
JAX package's Pallas kernels in interpret mode.

Inputs are numpy-seeded; parameters come from the port's seeded init and
are handed to the reference (``_torch_decode.j_tree``). Tolerances, all
in f32: the modules within FWD_LIMIT of max |out| (the f32 sums run in
another order; the 4-operand SSD einsums are contracted pairwise in the
order opt_einsum gives the reference, so only each pair's sum order
differs); ``_causal_conv`` and ``_segsum`` within 1e-6; the loss within
1e-5 absolute; the prefill on random W4 weights within FWD_LIMIT (the
decoded weights are the same numbers, the sums' order differs); the serve
forward on power-of-two scales with E2M1 acts within
``_torch_decode.F32_LIMIT`` of max |logit| with the same argmax (exact
W4A4 sums; the torch ops between the kernels differ by ulps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode import (  # noqa: F401 (fixtures)
    F32_LIMIT, j_tree, jax_interpret, k2_per_step, one_torch_thread,
    t_config)
from repro.configs import registry as jreg
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.models import lm as jlm
from repro.nn import attention as jattn
from repro.nn import moe as jmoe
from repro.nn import ssm as jssm
from repro.nn.embeddings import rope_frequencies as j_rope
from repro.quant.calibrate import QuantContext as JCtx
from repro.quant.fakequant import QuantizerParams as JQP
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import (dyadic_weights, make_prefill_step,
                                      quantize_lm_for_serving)
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tattn
from repro_torch.nn import moe as tmoe
from repro_torch.nn import ssm as tssm
from repro_torch.nn.embeddings import rope_frequencies
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams

ARCHS = list(jreg.ARCHS)
FWD_LIMIT = 1e-5      # max abs error over max |out|, f32
B, S = 2, 16


def jt(tree):
    """A tree of CPU tensors as the reference's jnp arrays."""
    return jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree)


def close(got, want, limit=FWD_LIMIT):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= limit, err


def rng_inputs(cfg, seed=0):
    """(tokens, extra) as numpy: (B, S) ids and, for the vlm, (B, n_img,
    d_vision) patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    extra = (rng.standard_normal((B, cfg.n_img_tokens, cfg.d_vision))
             .astype(np.float32) if cfg.family == "vlm" else None)
    return toks, extra


def both(toks, extra):
    """The inputs for each package: ((jnp tokens, jnp extra), (torch ...))."""
    j = (jnp.asarray(toks), None if extra is None else jnp.asarray(extra))
    t = (torch.from_numpy(toks), None if extra is None
         else torch.from_numpy(extra))
    return j, t


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    "dense": (dict(n_heads=4, n_kv=4), 16),
    "gqa, q_chunk < S": (dict(n_heads=4, n_kv=2), 4),
    "window, bias": (dict(n_heads=4, n_kv=2, window=5, qkv_bias=True), 4),
    "softcap": (dict(n_heads=4, n_kv=1, softcap=5.0), 8),
}


def test_mask_matches_reference():
    q_pos, k_pos = np.arange(4, 8), np.arange(12)
    for window in (None, 3):
        want = np.asarray(jattn._mask(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                      window))
        got = tattn._mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                          window).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_apply_matches_reference(case):
    kw, q_chunk = ATTN_CASES[case]
    tcfg = tattn.AttnConfig(d_model=32, head_dim=8, **kw)
    jcfg = jattn.AttnConfig(d_model=32, head_dim=8, **kw)
    tp = tattn.attn_init(torch.Generator().manual_seed(1), tcfg)
    if tcfg.qkv_bias:
        gen = torch.Generator().manual_seed(5)
        for name in ("wq", "wk", "wv"):
            tp[name]["b"] = torch.randn(tp[name]["b"].shape, generator=gen)
    x = np.random.default_rng(2).standard_normal((B, S, 32)).astype(
        np.float32)
    cos, sin = rope_frequencies(8, S, 10_000.0)
    jcos, jsin = j_rope(8, S, 10_000.0)
    want = jattn.attn_apply(jt(tp), jnp.asarray(x), jcos, jsin, jcfg,
                            q_chunk=q_chunk)
    got = tattn.attn_apply(tp, torch.from_numpy(x), cos, sin, tcfg,
                           q_chunk=q_chunk)
    close(got, want)


def test_attn_apply_refuses_a_ragged_chunk():
    cfg = tattn.AttnConfig(d_model=16, n_heads=2, n_kv=2, head_dim=8)
    tp = tattn.attn_init(torch.Generator().manual_seed(0), cfg)
    cos, sin = rope_frequencies(8, 6, 10_000.0)
    with pytest.raises(ValueError, match="multiple of the query chunk"):
        tattn.attn_apply(tp, torch.zeros(1, 6, 16), cos, sin, cfg, q_chunk=4)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def test_causal_conv_and_segsum_match_reference():
    rng = np.random.default_rng(3)
    xbc = rng.standard_normal((B, S, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b))
    got = tssm._causal_conv(*map(torch.from_numpy, (xbc, w, b)))
    close(got, want, 1e-6)
    a = -np.abs(rng.standard_normal((B, 3, 8))).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = tssm._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("init_state", [False, True])
def test_ssd_scan_matches_reference(init_state):
    rng = np.random.default_rng(4)
    h, p, n = 4, 8, 6
    x = rng.standard_normal((B, S, h, p)).astype(np.float32)
    dt_a = -np.abs(rng.standard_normal((B, S, h))).astype(np.float32) * 0.3
    bm = rng.standard_normal((B, S, h, n)).astype(np.float32)
    cm = rng.standard_normal((B, S, h, n)).astype(np.float32)
    st = (rng.standard_normal((B, h, p, n)).astype(np.float32)
          if init_state else None)
    jy, jst = jssm.ssd_scan(*map(jnp.asarray, (x, dt_a, bm, cm)), 4,
                            init_state=None if st is None
                            else jnp.asarray(st))
    ty, tst = tssm.ssd_scan(*map(torch.from_numpy, (x, dt_a, bm, cm)), 4,
                            init_state=None if st is None
                            else torch.from_numpy(st))
    close(ty, jy)
    close(tst, jst)
    assert tst.dtype == torch.float32


def test_ssm_apply_matches_reference():
    tcfg = tssm.SSMConfig(d_model=32, d_state=8, headdim=8, n_groups=2,
                          chunk=4)
    jcfg = jssm.SSMConfig(d_model=32, d_state=8, headdim=8, n_groups=2,
                          chunk=4)
    tp = tssm.ssm_init(torch.Generator().manual_seed(6), tcfg)
    gen = torch.Generator().manual_seed(7)
    for name in ("conv_b", "dt_bias", "D"):
        tp[name] = torch.randn(tp[name].shape, generator=gen) * 0.5
    x = np.random.default_rng(8).standard_normal((B, S, 32)).astype(
        np.float32)
    want = jssm.ssm_apply(jt(tp), jnp.asarray(x), jcfg)
    got = tssm.ssm_apply(tp, torch.from_numpy(x), tcfg)
    close(got, want)


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    tcfg = tmoe.MoEConfig(16, 32, 8, 2)
    jcfg = jmoe.MoEConfig(16, 32, 8, 2)
    _, ids = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 2)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(logits), ids, jcfg))
    got = float(tmoe.aux_load_balance_loss(
        torch.from_numpy(logits), torch.from_numpy(np.array(ids)), tcfg))
    assert got == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Every arch's smoke config in f32 (the vlm with patch embeddings,
    the audio config's sinusoidal positions), no quantization: the logits
    within FWD_LIMIT, the loss within 1e-5. The moe configs run with
    moe_impl "ep" too (meshless: moe_apply in both packages)."""
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = t_config(jcfg)
    tp = tlm.lm_init(torch.Generator().manual_seed(0), tcfg)
    jp = j_tree(tp)
    (jtok, jex), (ttok, tex) = both(*rng_inputs(jcfg))
    want = jlm.forward(jp, jcfg, jtok, jex)
    tops.reset_routes()
    with torch.no_grad():
        got = tlm.forward(tp, tcfg, ttok, tex)
    assert got.shape == (B, S, jcfg.vocab)
    close(got, want)
    # no packed weight, no context: only dense products
    assert {r for _, r in tops.ROUTES} <= {"torch_f32", "torch"}
    want_l = float(jlm.loss_fn(jp, jcfg, jtok, jex))
    with torch.no_grad():
        got_l = float(tlm.loss_fn(tp, tcfg, ttok, tex))
    assert abs(got_l - want_l) <= 1e-5, (got_l, want_l)
    if jcfg.family == "moe":
        ep = dataclasses.replace(tcfg, moe_impl="ep")
        with torch.no_grad():
            close(tlm.forward(tp, ep, ttok, tex), want)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b",
                                  "llama4-scout-17b-a16e"])
def test_prefill_step_on_w4_packs_matches_reference(arch):
    """make_prefill_step on W4 abs-max packs (per channel for the dense
    arch): no context, so every packed dense site and every expert product
    takes K2's weight-only mode (the plain version here), as the
    reference's ``ops.w4a4_matmul(x, w, None)``."""
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = t_config(jcfg)
    tp = quantize_lm_for_serving(
        tlm.lm_init(torch.Generator().manual_seed(1), tcfg),
        per_channel=(arch == "smollm-135m"), searched=False)
    jp = j_tree(tp)
    (jtok, jex), (ttok, tex) = both(*rng_inputs(jcfg, 1))
    want = jax.jit(j_make_prefill_step(jcfg))(jp, {"tokens": jtok})
    tops.reset_routes()
    got = make_prefill_step(tcfg)(tp, {"tokens": ttok})
    close(got, want)
    dense, expert = k2_per_step(jcfg)
    routes = dict(tops.ROUTES)
    assert routes.pop(("w4_matmul", "plain")) == dense + expert
    assert set(routes) <= {("tied_logits", "torch"), ("matmul", "torch_f32")}


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b",
                                  "llama4-scout-17b-a16e"])
def test_serve_forward_matches_reference_kernels(arch, jax_interpret):
    """forward under a serve context (E2M1 acts at maxval 6) on
    ``dyadic_weights`` packs: W4A4 K2 at every dense site, weight-only K2
    at every expert product, K1 before an untied head, against the
    reference's Pallas kernels in interpret mode. Logits within F32_LIMIT
    of max |logit|, the same argmax."""
    jcfg = jreg.get_config(arch, smoke=True)
    tcfg = t_config(jcfg)
    tp = quantize_lm_for_serving(dyadic_weights(
        tlm.lm_init(torch.Generator().manual_seed(2), tcfg)),
        per_channel=True, searched=False)
    jp = j_tree(tp)
    jctx = JCtx("serve", act_qps={"*": JQP(0, 2, 1, 4, jnp.float32(6.0))})
    tctx = QuantContext("serve", act_qps={"*": QuantizerParams(
        0, 2, 1, 4, torch.tensor(6.0))})
    (jtok, _), (ttok, _) = both(*rng_inputs(jcfg, 2))
    want = np.asarray(jlm.forward(jp, jcfg, jtok, ctx=jctx))
    tops.reset_routes()
    with torch.no_grad():
        got = tlm.forward(tp, tcfg, ttok, ctx=tctx).numpy()
    close(got, want, F32_LIMIT)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    dense, expert = k2_per_step(jcfg)
    routes = dict(tops.ROUTES)
    assert routes.pop(("w4a4_matmul", "plain")) == dense
    assert routes.pop(("w4_matmul", "plain"), 0) == expert
    if jcfg.tie_embeddings:
        assert routes == {("tied_logits", "torch"): 1}
    else:
        assert routes.pop(("msfp_quantize", "plain")) == 1
        assert set(routes) == {("matmul", "torch_f32")}


def test_dyadic_weights_shift_is_an_exact_power_of_two():
    """``dyadic_weights(shift=e)``: every quantizable weight is the
    unshifted one times 2^-e exactly (its column maxima 0.75 * 2^-(j+e)),
    every other leaf unchanged; its packs' maxvals stay 0.75 times powers
    of two (E2M1's grid steps, maxval / 6, powers of two)."""
    from repro_torch.common.tree import flatten_paths
    from repro_torch.core.qmodule import PackedW4
    from repro_torch.launch.steps import QUANT_WEIGHT_RE
    tcfg = t_config(jreg.get_config("zamba2-2.7b", smoke=True))
    params = tlm.lm_init(torch.Generator().manual_seed(1), tcfg)
    base = flatten_paths(dyadic_weights(params))
    shifted = flatten_paths(dyadic_weights(params, shift=3))
    quant = [k for k in base if QUANT_WEIGHT_RE.search(k)]
    assert quant and set(base) == set(shifted)
    for k, v in base.items():
        want = v * 2.0 ** -3 if k in quant else v
        assert torch.equal(shifted[k], want), k
    packs = {k: v for k, v in flatten_paths(quantize_lm_for_serving(
        dyadic_weights(params, shift=3), searched=False)).items()
        if isinstance(v, PackedW4)}
    assert set(packs) == set(quant)
    for k, pw in packs.items():
        e = torch.log2(pw.scale.float() / 0.75)     # maxval 0.75 * 2^-j
        assert torch.equal(e, e.round()) and bool((e <= -3).all()), k
