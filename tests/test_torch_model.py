"""Port parity: timestep embedding, the UNet forward (full precision and
serve-mode W4A4 over packed params) and the step-wise samplers.

Whole-forward tolerance: relative Frobenius error <= 1e-3 and at most 1%
of the elements off by more than 1e-4 (a one-ulp difference in a sum can
move an activation across a snap midpoint, and then one element by a
whole grid step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from _torch_parity import (assert_forward_close, j_packed, jx, t,
                           tiny_unet_params)
from repro.configs.diffusion_presets import tiny_ddim as j_tiny
from repro.diffusion import samplers as jsamp
from repro.diffusion.schedule import make_schedule as j_sched
from repro.nn.embeddings import timestep_embedding as j_temb
from repro.nn.unet import io_sites as j_io_sites
from repro.nn.unet import unet_apply as j_apply
from repro.quant.calibrate import QuantContext as JCtx
from repro.quant.fakequant import QuantizerParams as JQP
from repro_torch.common.tree import flatten_paths, unflatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.core.qmodule import PackedW4
from repro_torch.diffusion import samplers as tsamp
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.kernels import ops as tops
from repro_torch.nn.embeddings import timestep_embedding
from repro_torch.nn.unet import unet_apply
from repro_torch.quant.calibrate import QuantContext
from repro_torch.quant.fakequant import QuantizerParams
from repro_torch.serving.weight_bank import (default_serving_plan,
                                             pack_param_tree)


@pytest.fixture
def jax_ref_kernels():
    """The JAX package's pure ref.py oracles (no fast XLA serving path)."""
    old = jops.FORCE
    jops.FORCE = "xla"
    yield
    jops.FORCE = old


def test_timestep_embedding_matches(rng):
    """exp may differ by one ulp between XLA and torch; t up to 1000
    magnifies that in cos/sin's argument to about 1000 * 2^-24 * t-scale,
    hence atol 1e-4."""
    ts = rng.integers(0, 1000, size=17).astype(np.float32)
    for dim in (32, 33, 128):
        np.testing.assert_allclose(
            timestep_embedding(t(ts), dim).numpy(),
            np.asarray(j_temb(jx(ts), dim)), rtol=1e-5, atol=1e-4)


def _model(size=8, seed=0):
    return (j_tiny(size), *tiny_unet_params(size, seed))


def _weights(flat):
    return {k: v for k, v in flat.items()
            if k.endswith("/w") and getattr(v, "ndim", 0) >= 2}


def test_unet_fp_forward_matches(rng):
    cfg, jp, tp = _model()
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    ts = np.array([3.0, 71.0], np.float32)
    want = jax.jit(lambda p, x, ts: j_apply(p, x, ts, cfg))(jp, jx(x), jx(ts))
    got = unet_apply(tp, t(x), t(ts), tiny_ddim(8), ctx=QuantContext("off"))
    assert_forward_close(got.numpy(), np.asarray(want))


def test_unet_serve_forward_matches(rng, jax_ref_kernels):
    """Serve-mode W4A4 forward over the same packed params (signed E2M1
    abs-max weights, E2M1 acts at maxval 6, bf16-fallback io sites)."""
    cfg, jp, tp = _model()
    tq, tstats = pack_param_tree(tp, default_serving_plan(
        _weights(flatten_paths(tp)), io_sites=j_io_sites(jp)))
    assert sorted(tstats["fallback"]) == ["conv_in/w", "conv_out/w"]
    jq = unflatten_paths({
        k: j_packed(v) if isinstance(v, PackedW4)
        else jnp.asarray(v.to(torch.float32).numpy()).astype(v_dtype(v))
        for k, v in flatten_paths(tq).items()})
    x = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    ts = np.array([5.0, 40.0, 99.0], np.float32)
    jctx = JCtx("serve", act_qps={"*": JQP(0, 2, 1, 4, jnp.float32(6.0))})
    tctx = QuantContext("serve", act_qps={"*": QuantizerParams(
        0, 2, 1, 4, torch.tensor(6.0))})
    want = jax.jit(lambda p, x, ts: j_apply(p, x, ts, cfg, ctx=jctx))(
        jq, jx(x), jx(ts))
    tops.reset_routes()
    got = unet_apply(tq, t(x), t(ts), tiny_ddim(8), ctx=tctx)
    assert_forward_close(got.numpy(), np.asarray(want))
    # every site ran a kernel's plain version, the io convs (snap, conv
    # and bias) one qdq_conv2d each
    assert {r for _, r in tops.ROUTES} == {"plain", "plain:implicit"}
    assert tops.ROUTES[("conv2d", "plain")] == 2


def v_dtype(v):
    return jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32


def _eps(x, t_):
    return 0.1 * x + 0.01 * t_ / 100.0


@pytest.mark.parametrize("kind,steps", [("ddim", 5), ("plms", 6),
                                        ("dpm_solver2", 4),
                                        ("dpm_solver2", 1)])
def test_step_samplers_match(kind, steps, rng):
    jsch, tsch = j_sched("linear", 100), make_schedule("linear", 100)
    np.testing.assert_array_equal(tsch.alpha_bars.numpy(),
                                  np.asarray(jsch.alpha_bars))
    js = jsamp.sampler_init(kind, jsch, (1, 4, 4, 3), jax.random.PRNGKey(3),
                            steps=steps)
    ts = tsamp.sampler_init(kind, tsch, (1, 4, 4, 3), steps=steps,
                            x_T=t(np.asarray(js.x)))
    needed = []
    while not js.done:
        tj, tt = jsamp.sampler_needed_t(js), tsamp.sampler_needed_t(ts)
        assert tj == tt
        needed.append(tj)
        jsamp.sampler_advance(js, _eps(js.eval_x, tj))
        tsamp.sampler_advance(ts, _eps(ts.eval_x, tt))
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x),
                                   rtol=1e-5, atol=1e-6)
    assert ts.done and len(needed) >= steps
