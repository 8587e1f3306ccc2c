"""Port parity for the Mamba2 decode (``nn/ssm.py``) and the ssm and
hybrid families' decode (mamba2-370m, zamba2-2.7b smoke configs), each
against the JAX package on the same numbers.

Tolerances:
  * ``ssm_decode`` on dense f32 weights: out and state rtol = atol = 1e-5
    (XLA's and torch's exp, softplus and sums differ by ulps); the bf16
    conv buffer within one bf16 rounding (rtol 2^-8): an ulp of f32 sum
    order in in_proj can round a buffered value to the neighbouring bf16.
    bf16 weights: relative Frobenius error <= 2e-2 (XLA's CPU bf16
    arithmetic, ROADMAP Queue C).
  * family decodes: ``_torch_decode.py`` (F32_LIMIT, SSM_F32_LIMIT,
    BF16_LIMIT).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_decode import (  # noqa: F401 (fixtures)
    CASES, JDTYPE, decode_parity, jax_interpret, one_torch_thread,
    same_specs, t_config)
from _torch_parity import t
from repro.configs.registry import get_config as j_get_config
from repro.models.lm import cache_specs as j_cache_specs
from repro.nn import ssm as jssm
from repro_torch.models import lm as tlm
from repro_torch.nn import ssm as tssm

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(dtype, seed=0):
    cfg_t = tssm.SSMConfig(32, d_state=16, headdim=16, n_groups=2)
    cfg_j = jssm.SSMConfig(32, d_state=16, headdim=16, n_groups=2)
    tp = tssm.ssm_init(torch.Generator().manual_seed(seed), cfg_t,
                       dtype=dtype)
    tp["dt_bias"] = torch.linspace(-2.0, 1.0, cfg_t.n_heads).to(dtype)
    tp["D"] = torch.linspace(0.5, 1.5, cfg_t.n_heads).to(dtype)
    tp["conv_b"] = (torch.arange(cfg_t.conv_dim) % 7 * 0.05).to(dtype)
    jp = jax.tree.map(lambda v: jnp.asarray(v.float().numpy()).astype(
        JDTYPE[v.dtype]), tp)
    return cfg_t, cfg_j, tp, jp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_decode_matches_reference(dtype):
    """Five steps from a zero state on dense weights with non-zero biases,
    two B/C groups; the conv buffer is bf16 on both sides whatever the
    model's dtype."""
    cfg_t, cfg_j, tp, jp = _pair(dtype)
    b = 3
    xs = np.random.default_rng(1).normal(size=(5, b, 1, 32)).astype(
        np.float32)
    tc = tssm.init_ssm_state(b, cfg_t)
    jc = jssm.init_ssm_state(b, cfg_j)
    assert tc["conv"].dtype == torch.bfloat16
    assert tc["state"].dtype == torch.float32
    step = jax.jit(lambda c, x: jssm.ssm_decode(jp, x, c, cfg_j))
    for i in range(5):
        jx = jnp.asarray(xs[i]).astype(JDTYPE[dtype])
        want, jc = step(jc, jx)
        got, tc = tssm.ssm_decode(tp, t(xs[i]).to(dtype), tc, cfg_t)
        assert got.dtype == dtype and got.shape == (b, 1, 32)
        w = t(np.asarray(want.astype(jnp.float32)))
        if dtype == torch.float32:
            torch.testing.assert_close(got, w, **TOL)
            torch.testing.assert_close(tc["state"], t(jc["state"]), **TOL)
        else:
            rel = float((got.float() - w).norm() / w.norm())
            assert rel <= 2e-2, rel
        torch.testing.assert_close(
            tc["conv"].float(), t(np.asarray(jc["conv"].astype(jnp.float32))),
            rtol=2.0**-8, atol=1e-6)


def test_ssm_state_spec_matches_reference():
    cfg_t = tssm.SSMConfig(64, d_state=16, headdim=16)
    cfg_j = jssm.SSMConfig(64, d_state=16, headdim=16)
    same_specs(tssm.ssm_state_spec(2, cfg_t), jssm.ssm_state_spec(2, cfg_j))
    assert (cfg_t.d_inner, cfg_t.n_heads, cfg_t.conv_dim) == \
        (cfg_j.d_inner, cfg_j.n_heads, cfg_j.conv_dim)


def test_softplus_matches_jax():
    """Within 2e-7 relative (an ulp or two of exp and log1p); below the
    smallest normal f32 (softplus(-100)) XLA's CPU flushes to zero where
    torch keeps the subnormal."""
    x = np.concatenate([np.linspace(-40, 40, 401),
                        [-100.0, 0.0, 19.99, 20.01, 88.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    torch.testing.assert_close(tssm.softplus(t(x)), t(want), rtol=2e-7,
                               atol=float(np.finfo(np.float32).tiny))


def test_split_proj_matches_reference():
    cfg_t = tssm.SSMConfig(32, d_state=16, headdim=16, n_groups=2)
    cfg_j = jssm.SSMConfig(32, d_state=16, headdim=16, n_groups=2)
    n = 2 * cfg_t.d_inner + 2 * cfg_t.n_groups * cfg_t.d_state \
        + cfg_t.n_heads
    v = np.arange(3 * n, dtype=np.float32).reshape(3, n)
    for a, b in zip(tssm._split_proj(t(v), cfg_t),
                    jssm._split_proj(jnp.asarray(v), cfg_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_family_decode_matches(arch, case, jax_interpret):
    """8 teacher-forced steps of the arch's smoke config (zamba2: the
    shared attention block after each group of SSM layers, its own KV
    cache per group), the port against the reference."""
    decode_parity(j_get_config(arch, smoke=True), *CASES[case])


def test_hybrid_caches_stack_shared_attention_per_group():
    """zamba2's caches: an SSM state and conv buffer per pattern position
    and one KV cache per group for the shared block, stacked over
    groups."""
    jcfg = dataclasses.replace(j_get_config("zamba2-2.7b", smoke=True),
                               kv_dtype="fp4")
    ts = tlm.cache_specs(t_config(jcfg), 2, 8)
    same_specs(ts, j_cache_specs(jcfg, 2, 8))
    assert set(ts) == {"blocks", "shared"}
    assert ts["shared"]["k"]["shape"][0] == jcfg.n_groups
