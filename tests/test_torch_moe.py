"""Port parity for the MoE layer (``nn/moe.py``) and the moe family's
decode (llama4-scout and kimi-k2 smoke configs: top-1 and top-2 routing,
a shared expert, kimi's leading dense layer), each against the JAX
package on the same numbers.

Tolerances:
  * ``capacity``, ``_positions_in_segment``, ``top_k`` (ties included):
    exact.
  * ``moe_apply`` in f32: rtol = atol = 1e-5 (the expert products sum in
    another order; on power-of-two weight scales the shared expert's
    W4A4 sums are exact); in bf16, relative Frobenius error <= 2e-2: the
    reference's bf16 einsum rounds each decoded weight to bf16 and XLA
    keeps f32 between fused ops, the port's K2 decodes in f32 (ROADMAP
    Queue C).
  * family decodes: ``_torch_decode.py`` (F32_LIMIT, BF16_LIMIT).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode import (  # noqa: F401 (fixtures)
    CASES, JDTYPE, decode_parity, j_tree, jax_interpret, one_torch_thread)
from _torch_parity import t
from repro.configs.registry import get_config as j_get_config
from repro.nn import moe as jmoe
from repro.quant.calibrate import QuantContext as JCtx
from repro.quant.fakequant import QuantizerParams as JQP
from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import dyadic_weights, quantize_lm_for_serving
from repro_torch.nn import moe as tmoe
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_tokens", [1, 8, 33, 512, 4096])
@pytest.mark.parametrize("e,k,cf", [(16, 1, 1.25), (384, 8, 1.25),
                                    (4, 2, 2.0), (8, 2, 1.0)])
def test_capacity_matches_reference(n_tokens, e, k, cf):
    kw = dict(d_model=8, d_ff=8, n_experts=e, top_k=k, capacity_factor=cf)
    assert tmoe.capacity(n_tokens, tmoe.MoEConfig(**kw)) == \
        jmoe.capacity(n_tokens, jmoe.MoEConfig(**kw))


def test_positions_in_segment_matches_reference():
    rng = np.random.default_rng(0)
    for n, hi in ((1, 3), (17, 3), (200, 9), (64, 1)):
        ids = np.sort(rng.integers(0, hi, n)).astype(np.int32)
        want = np.asarray(jmoe._positions_in_segment(jnp.asarray(ids)))
        got = tmoe._positions_in_segment(torch.from_numpy(ids).long())
        np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_takes_the_lower_index_first_on_ties():
    """``lax.top_k``'s order, ties included: rows of repeated values."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(t(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _moe(dtype, packed: bool, per_channel: bool):
    """A 4-expert top-2 layer with a shared expert whose router sends
    every token to expert 0 first: 36 tokens over capacity 24 (cf 1), so
    12 of expert 0's assignments drop."""
    cfg_t = tmoe.MoEConfig(32, 24, 4, 2, n_shared=1, capacity_factor=1.0)
    cfg_j = jmoe.MoEConfig(32, 24, 4, 2, n_shared=1, capacity_factor=1.0)
    p = tmoe.moe_init(torch.Generator().manual_seed(3), cfg_t, dtype=dtype)
    p["router"]["w"][0, 0] += 40.0     # x[..., 0] is set >= 1 below
    tree = {"moe": p}
    if packed:
        tree = quantize_lm_for_serving(dyadic_weights(tree),
                                       per_channel=per_channel, searched=False)
    x = np.random.default_rng(4).normal(size=(3, 12, 32)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    return cfg_t, cfg_j, tree["moe"], j_tree(tree)["moe"], x


@pytest.mark.parametrize("dtype,packed,per_channel", [
    (torch.float32, False, False), (torch.float32, True, False),
    (torch.float32, True, True), (torch.bfloat16, True, False)])
def test_moe_apply_matches_reference(dtype, packed, per_channel):
    """Overflowing capacity (drops), top-2, a shared expert; packed
    weights under a serve-mode context: every expert product runs K2's
    weight-only mode (E x 3 calls), the shared expert W4A4 (3), the
    router one plain f32 product, and no oracle."""
    cfg_t, cfg_j, tp, jp, x = _moe(dtype, packed, per_channel)
    t_cap = tmoe.capacity(36, cfg_t)
    loads = np.bincount(np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, 32)) @ jp["router"]["w"]), 2)[1]).ravel(),
        minlength=4)
    assert loads[0] == 36 > t_cap == 24
    jctx = tctx = None
    if packed:
        jctx = JCtx("serve", act_qps={"*": JQP(0, 2, 1, 4, jnp.float32(6.0))})
        tctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0))})
    want = jax.jit(lambda v: jmoe.moe_apply(jp, v, cfg_j, ctx=jctx,
                                            site="m"))(
        jnp.asarray(x).astype(JDTYPE[dtype]))
    tops.reset_routes()
    got = tmoe.moe_apply(tp, t(x).to(dtype), cfg_t, ctx=tctx, site="m")
    w = t(np.asarray(want.astype(jnp.float32)))
    assert got.dtype == dtype and got.shape == (3, 12, 32)
    if dtype == torch.float32:
        torch.testing.assert_close(got, w, **TOL)
    else:
        rel = float((got.float() - w).norm() / w.norm())
        assert rel <= 2e-2, rel
    routes = dict(tops.ROUTES)
    assert "ref" not in {r for (_, r) in routes}, routes
    if packed:
        assert routes == {("w4_matmul", "plain"): 4 * 3,
                          ("w4a4_matmul", "plain"): 3,
                          ("matmul", "torch_f32"): 1}, routes
    else:
        assert routes == {("matmul", "torch_f32"): 1 + 3 + 3}, routes


def test_expert_packs_split_a_stack_with_its_scales():
    """An (E, K, N/2) pack's per-expert (E, 1, 1) or per-channel (E, 1, N)
    scales, or a layer slice's shared (1, 1, 1|N) one, go to each expert
    as a scalar or an (N,) vector, and each expert's 2D pack decodes to
    its slice of the stack."""
    from repro_torch.core.qmodule import dequant_weight
    from repro_torch.models.lm import _slice
    w = torch.randn(2, 3, 8, 6, generator=torch.Generator().manual_seed(5))
    for pc in (False, True):
        stacked = quantize_lm_for_serving({"w_up": w}, per_channel=pc,
                                          searched=False)["w_up"]
        whole = dequant_weight(stacked, torch.float32)
        for g in range(2):
            layer = _slice({"w_up": stacked}, g)["w_up"]
            single = quantize_lm_for_serving({"w_up": w[g]},
                                             per_channel=pc,
                                             searched=False)["w_up"]
            for pack, shared in ((layer, True), (single, False)):
                for e, pe in enumerate(tmoe.expert_packs(pack)):
                    assert isinstance(pe, PackedW4) and pe.packed.ndim == 2
                    assert pe.scale.shape == ((6,) if pc else ())
                    assert pe.shape == (8, 6)
                    if shared:
                        torch.testing.assert_close(
                            dequant_weight(pe, torch.float32), whole[g, e],
                            rtol=0, atol=0)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_moe_family_decode_matches(arch, case, jax_interpret):
    """8 teacher-forced steps of the arch's smoke config, the port against
    the reference; every expert product runs K2's weight-only plain
    version (E x 3 a MoE layer and step) under W4A4 too."""
    decode_parity(j_get_config(arch, smoke=True), *CASES[case])
