"""Teacher-forced LM decode, the port against the JAX package, for any
``LMConfig`` of either package (tests/test_torch_lm_families.py,
test_torch_ssm.py, test_torch_moe.py).

The port's seeded init (optionally ``steps.dyadic_weights``) and its W4
packs are handed to the reference, so both run the same numbers; the
layouts and pack bytes are held identical by the tests beside this. Both
sides decode 8 steps from empty caches, each carrying its own caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import j_packed
from repro.launch.steps import make_decode_fn as j_make_decode_fn
from repro.models.lm import init_caches as j_init_caches
from repro.quant.calibrate import QuantContext as JCtx
from repro.quant.fakequant import QuantizerParams as JQP
from repro_torch.core.qmodule import PackedW4
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import (dyadic_weights, make_decode_fn,
                                      quantize_lm_for_serving)
from repro_torch.models import lm as tlm
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams

TDTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
MLP_SITES = {"swiglu": 3, "geglu": 3, "gelu": 2}

# (model dtype, kv cache, per-channel W4, E2M1 acts fused, dyadic weights):
#   W4A4 on power-of-two scales, per channel (every product sums exactly
#   in either order, so the k/v rounded into a bf16 cache, and the bf16
#   SSM conv buffer, round alike); W4 with acts off on random weights with
#   the FP4 cache (K4's per-row absmax and E2M1 snap absorb an ulp of sum
#   order where a bf16 cache's rounding would not: a bf16 k or v one ulp
#   apart moves a logit by 2^-8 of itself); a bf16 model with acts off
#   and a bf16 cache (XLA's CPU bf16 arithmetic keeps f32 between fused
#   ops: ROADMAP Queue C).
CASES = {"f32-w4a4-bf16kv": (jnp.float32, "bf16", True, True, True),
         "f32-w4-fp4": (jnp.float32, "fp4", False, False, False),
         "bf16-w4-bf16kv": (jnp.bfloat16, "bf16", False, False, False)}
F32_LIMIT = 1e-4     # max abs error over max |logit|, every step
# ... for an f32 model with SSM layers and acts off: the SSM conv buffer
# is bf16 whatever the model's dtype (the reference's), so an ulp of sum
# order in in_proj's output can round a buffered input one bf16 ulp
# (2^-8 of itself) apart, which the recurrence carries on (zamba2's smoke
# config: 1-3 of 1920 buffered values a step, 3.4e-4 by step 8); on
# power-of-two scales with the acts snapped the sums are exact and the
# case is held at F32_LIMIT
SSM_F32_LIMIT = 2e-3
BF16_LIMIT = 2e-2    # relative Frobenius error over the 8 steps


@pytest.fixture
def jax_interpret():
    """The JAX package's Pallas kernels in interpret mode (on the CPU its
    kv4 dispatch otherwise takes the ref.py oracles)."""
    import repro.kernels.ops as jops
    old = jops.FORCE
    jops.FORCE = "interpret"
    yield
    jops.FORCE = old


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a file that imports this runs: the smoke
    configs' tensors are small, and under the suite's parallel workers
    torch's threads spin against each other's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_specs(ts, js) -> None:
    """Two cache-spec trees (the port's torch dtypes, the reference's jnp
    ones) name the same tensors with the same shapes and dtypes."""
    if isinstance(ts, dict) and "shape" in ts:
        assert ts["shape"] == tuple(js["shape"])
        assert str(ts["dtype"]).split(".")[-1] == jnp.dtype(js["dtype"]).name
    elif isinstance(ts, dict):
        assert set(ts) == set(js)
        for k in ts:
            same_specs(ts[k], js[k])
    else:
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            same_specs(a, b)


def t_config(jcfg, **kw) -> tlm.LMConfig:
    """The reference's config as the port's, field for field."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(tlm.LMConfig)}
    fields["dtype"] = TDTYPE[jcfg.dtype]
    fields.update(kw)
    return tlm.LMConfig(**fields)


def j_tree(tp):
    """The port's (packed) params as the reference's: each leaf keeps its
    dtype (the MoE router stays f32 in a bf16 model)."""
    return jax.tree.map(
        lambda v: j_packed(v) if isinstance(v, PackedW4)
        else jnp.asarray(v.float().numpy()).astype(JDTYPE[v.dtype]), tp,
        is_leaf=lambda v: isinstance(v, PackedW4))


def k2_per_step(cfg) -> tuple[int, int]:
    """(dense-site K2 calls, expert K2 calls) of one decode step, counted
    from the config: 4 an attention layer, the MLP's 2 or 3, the shared
    expert's 3, 2 an SSM layer, 3 an expert of a MoE layer."""
    mlp = MLP_SITES[cfg.mlp_kind]
    dense = cfg.first_k_dense * (4 + mlp)
    expert = 0
    for kind, _, _ in cfg.layer_pattern:
        if kind == "ssm":
            dense += 2 * cfg.n_groups
            continue
        dense += 4 * cfg.n_groups
        if cfg.family == "moe":
            dense += 3 * bool(cfg.n_shared) * cfg.n_groups
            expert += 3 * cfg.n_experts * cfg.n_groups
        elif cfg.d_ff:
            dense += mlp * cfg.n_groups
    if cfg.shared_attn_every:
        dense += (4 + (mlp if cfg.d_ff else 0)) * cfg.n_groups
    return dense, expert


def decode_parity(jcfg, dt, kv, pc, act, dy, *, seed=2, b=2, steps=8):
    """Decode ``steps`` teacher-forced tokens through both packages and
    hold the port to the reference (F32_LIMIT, SSM_F32_LIMIT or
    BF16_LIMIT); assert every
    packed site ran K2's plain version (dense sites in the mode ``act``
    asks for, every expert product weight-only) and no ``ref`` route ran.
    Returns (got, want) logits, (steps, b, 1, vocab)."""
    jcfg = dataclasses.replace(jcfg, dtype=dt, kv_dtype=kv)
    tcfg = t_config(jcfg)
    tp = tlm.lm_init(torch.Generator().manual_seed(seed), tcfg)
    if dy:
        tp = dyadic_weights(tp)
    tp = quantize_lm_for_serving(tp, per_channel=pc, searched=False)
    jp = j_tree(tp)
    jctx = tctx = None
    if act:
        jctx = JCtx("serve", act_qps={"*": JQP(0, 2, 1, 4, jnp.float32(6.0))})
        tctx = QuantContext("serve", act_qps={"*": QuantizerParams(
            0, 2, 1, 4, torch.tensor(6.0))})
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
    routes = dict(tops.ROUTES)
    assert "ref" not in {r for (_, r) in routes}, routes
    dense, expert = k2_per_step(jcfg)
    if act:
        assert routes.get(("w4a4_matmul", "plain"), 0) == dense * steps
        assert routes.get(("w4_matmul", "plain"), 0) == expert * steps
    else:
        assert routes.get(("w4_matmul", "plain"), 0) == \
            (dense + expert) * steps
        assert ("w4a4_matmul", "plain") not in routes
    if dt == jnp.float32:
        ssm = any(kind == "ssm" for kind, _, _ in jcfg.layer_pattern)
        limit = SSM_F32_LIMIT if ssm and not act else F32_LIMIT
        scale = np.abs(want).max(axis=(1, 2, 3))
        err = np.abs(got - want).max(axis=(1, 2, 3))
        assert (err <= limit * scale).all(), err / scale
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_LIMIT, rel
    return got, want
