"""Port parity: TALoRA + DFA fine-tune steps, from the reference's state.

The reference's ``finetune`` jits an inner ``train_step`` (teacher eps
under stop_gradient, the student's TALoRA-merged quantize-mode eps, the
DFA loss, ``value_and_grad``, ``adam_update``); ``reference_step`` below
is that function as written there. The port's ``train.finetune.
train_step`` takes the same state, converted (``convert.py``): the
fake-quantized tree, the plan, the hubs, the router and the Adam state,
and the same batch, timesteps and gamma_t.

The plan has power-of-two scales (every maxval ``base_max * 2^k``), so
every weight and act is a grid point times a power of two, and the
forward's convs and products sum exactly: the forward agrees up to the
ulps of the ops between them (GroupNorm, SiLU, softmax), the backward up
to its f32 sums. Two steps, since at step 1 every B is 0 and the
gradients of every A and of the router are exactly 0 (checked).

Tolerance (``train.finetune.STEP_LIMIT``, ``step_errors``): relative 1e-3
on the loss, the grad norm and the gradient of every leaf (Frobenius over
each leaf), and on every updated leaf and moment (Frobenius over each
leaf of the change the step made). Measured here: at most 1.9e-6 at step 1 and 5.1e-5 at step 2 (the
smallest gradients, whose sums cancel most); the limit leaves room for
another thread count's sum order. Two control faults must each break
it: the 'plain' loss in place of 'dfa' (reads 32) and an STE without its
clip mask (reads 0.70 on the gradients).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import np_plan, np_tree, tiny_unet_params
from repro.common.tree import flatten_paths as jflat
from repro.common.tree import unflatten_paths as junflat
from repro.core import dfa as jdfa
from repro.core import msfp as jmsfp
from repro.core import talora as jtal
from repro.configs.diffusion_presets import tiny_ddim as jtiny
from repro.diffusion import pipeline as jpipe
from repro.diffusion.schedule import make_schedule as jmake_schedule
from repro.nn.unet import io_sites, unet_apply as junet_apply
from repro.optim import adam as jadam
from repro.quant import fakequant as jfq
from repro.train import finetune as jft
from repro_torch import convert
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.core import talora as ttal
from repro_torch.diffusion import pipeline as tpipe
from repro_torch.diffusion.schedule import make_schedule as tmake_schedule
from repro_torch.kernels import ops
from repro_torch.quant import calibrate as tcal
from repro_torch.quant import fakequant as tfq
from repro_torch.train import finetune as tft
from repro_torch.train.finetune import STEP_LIMIT, step_errors

TALORA = dict(hub_size=2, rank=4, t_emb_dim=32, router_hidden=16)
B = 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this file runs: under the suite's parallel
    workers, torch's parallel regions over the search's grids spin against
    each other's threads (a plan test took ten minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pow2_maxval(absmax: float, base_max: float) -> float:
    """base_max * 2^k with 2^k <= 0.7 absmax / base_max: a power-of-two
    grid scale that clips the top of the range (so the STE mask cuts)."""
    k = np.floor(np.log2(max(0.7 * absmax, 1e-12) / base_max))
    return float(base_max * 2.0**k)


def dyadic_plan(jp, tp, cfg):
    """The reference's QuantPlan on power-of-two scales: weights sE2M1 (io
    sE2M5), NAL acts sE2M1, AAL acts uE2M2 with zp -0.25, io acts sE2M5;
    the sites and AAL classes from a port calibration forward."""
    db = tcal.CalibrationDB(1024)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, 8, 8, 3)).astype(np.float32))
    with torch.no_grad():
        tpipe.unet_apply(tp, x, torch.full((B,), 30.0), cfg,
                         ctx=tcal.QuantContext("collect", db=db))
    io = io_sites(jp)
    sites = {}

    def qp(kind, e, m, bits, absmax, zp=0.0):
        bm = jfq.QuantizerParams(kind, e, m, bits).fmt.base_max
        return jfq.QuantizerParams(kind, e, m, bits,
                                   jnp.float32(_pow2_maxval(absmax, bm)),
                                   jnp.float32(zp))

    for k, w in jflat(jp).items():
        if k.endswith("/w"):
            e, m, bits = (2, 5, 8) if k in io else (2, 1, 4)
            sites[k] = jmsfp.SiteInfo(qp(0, e, m, bits, float(jnp.abs(w).max())),
                                      True, False, 0.0)
    for k, s in db.sites.items():
        absmax = max(abs(s.x_min), abs(s.x_max))
        aal = db.is_aal(k)
        if k in io:
            q = qp(0, 2, 5, 8, absmax)
        elif aal:
            q = qp(1, 2, 2, 4, s.x_max, -0.25)
        else:
            q = qp(0, 2, 1, 4, absmax)
        sites[k] = jmsfp.SiteInfo(q, False, aal, 0.0)
    assert any(s.is_aal for s in sites.values())
    return jmsfp.QuantPlan(sites, 4, 4, "msfp")


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = jtiny(8), tiny_ddim(8)
    jp, tp = tiny_unet_params(8, seed=1)
    jsched, tsched = jmake_schedule("linear", 50), tmake_schedule("linear", 50)
    jplan = dyadic_plan(jp, tp, cfg_t)
    jw = {k: v for k, v in jflat(jp).items() if k.endswith("/w")}
    flat = dict(jflat(jp))
    flat.update(jmsfp.quantize_weight_tree(jw, jplan))
    jq = junflat(flat)
    tcfg = jtal.TALoRAConfig(**TALORA)
    dims = jtal.lora_target_dims_from_weights(
        {k: v for k, v in jflat(jq).items() if k.endswith("/w")})
    hubs = jtal.init_lora_hub(jax.random.PRNGKey(11), dims, tcfg)
    router = jtal.init_router(jax.random.PRNGKey(12), len(dims), tcfg)
    jb = jpipe.QuantizedDiffusion(cfg_j, jsched, jp, jq, jplan, tcfg, hubs,
                                  router)
    tb = tpipe.QuantizedDiffusion(
        cfg_t, tsched, tp, convert.from_numpy_tree(np_tree(jq), "cpu"),
        convert.plan_from_numpy(np_plan(jplan), "cpu"),
        ttal.TALoRAConfig(**TALORA),
        convert.from_numpy_tree(np_tree(hubs), "cpu"),
        convert.from_numpy_tree(np_tree(router), "cpu"))
    rng = np.random.default_rng(5)
    batches = [(rng.normal(size=(B, 8, 8, 3)).astype(np.float32), float(tt))
               for tt in (37, 12)]
    gammas = np.asarray(jsched.gamma())
    return dict(jb=jb, tb=tb, batches=batches, gammas=gammas, T=50)


def reference_step(bundle, ft):
    """The reference's inner train_step (src/repro/train/finetune.py),
    returning the gradients beside (tr, opt, loss, metrics)."""
    cfg = bundle.cfg
    acfg = jadam.AdamConfig(lr=ft.lr, clip_norm=1.0)
    eps_fn = jft.make_student_eps(bundle, ft)
    teacher = jax.jit(lambda x, t: junet_apply(bundle.fp_params, x, t, cfg))

    @partial(jax.jit, static_argnames=("t_frac_key",))
    def train_step(tr, opt, x, tb, gamma_t, key, t_frac_key):
        t_frac = jnp.float32(t_frac_key)

        def loss(tr):
            eps_t = jax.lax.stop_gradient(teacher(x, tb))
            eps_s = eps_fn(tr["hubs"], tr["router"], x, tb, key, t_frac)
            if ft.loss_mode == "dfa":
                return jdfa.dfa_loss(eps_t, eps_s, gamma_t)
            return jdfa.plain_loss(eps_t, eps_s)

        l, g = jax.value_and_grad(loss)(tr)
        tr, opt, metrics = jadam.adam_update(g, opt, tr, acfg)
        return tr, opt, l, metrics, g

    return train_step


def run_reference(s, steps=2):
    jb = s["jb"]
    ft = jft.FinetuneConfig(batch=B)
    step = reference_step(jb, ft)
    tr = {"hubs": jb.hubs, "router": jb.router}
    opt = jadam.adam_init(tr, jadam.AdamConfig(lr=ft.lr, clip_norm=1.0))
    out = []
    for x, tt in s["batches"][:steps]:
        tb = jnp.full((B,), tt, jnp.float32)
        g_t = jnp.full((B,), s["gammas"][int(tt)], jnp.float32)
        tr, opt, l, m, g = step(tr, opt, jnp.asarray(x), tb, g_t,
                                jax.random.PRNGKey(0), tt / s["T"])
        out.append({k: convert.from_numpy_tree(np_tree(v), "cpu")
                    for k, v in dict(tr=tr, opt=opt, loss=l,
                                     grad_norm=m["grad_norm"],
                                     grads=g).items()})
    return out


def run_port(s, steps=2, **ft_kw):
    tb_ = s["tb"]
    ft = tft.FinetuneConfig(batch=B, **ft_kw)
    tr = {"hubs": tb_.hubs, "router": tb_.router}
    opt = tadam_init(tr, ft)
    out = []
    for x, tt in s["batches"][:steps]:
        tbt = torch.full((B,), tt)
        g_t = torch.full((B,), float(s["gammas"][int(tt)]))
        tr, opt, l, m = tft.train_step(tb_, ft, tr, opt, torch.from_numpy(x),
                                       tbt, g_t, t_frac=tt / s["T"])
        out.append(dict(tr=tr, opt=opt, loss=l, grad_norm=m["grad_norm"],
                        grads=m["grads"]))
    return out


def tadam_init(tr, ft):
    from repro_torch.optim.adam import adam_init
    return adam_init(tr, ft.adam())


def held(errs) -> bool:
    return all(v <= STEP_LIMIT for v in errs.values())


@pytest.fixture(scope="module")
def ref_steps(setup):
    return run_reference(setup)


def test_two_train_steps_match_reference(setup, ref_steps):
    """Loss, grad norm, every gradient, updated leaf and moment of two
    steps within STEP_LIMIT; at step 1 only the B's move."""
    ops.reset_routes()
    port = run_port(setup)
    assert ops.ROUTES[("msfp_quantize", "plain")] > 0    # the STE's K1
    assert ops.ROUTES[("conv2d", "plain")] > 0           # qdq_conv2d's
    prev = {"hubs": setup["tb"].hubs, "router": setup["tb"].router}
    for i, (p, r) in enumerate(zip(port, ref_steps)):
        errs = step_errors(p, r, prev)
        print(f"step {i + 1}: loss {p['loss']!r} (reference {r['loss']!r}), "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        assert held(errs), errs
        prev = p["tr"]
    g1 = flatten_paths(ref_steps[0]["grads"])
    assert all(not v.any() for k, v in g1.items()
               if k.endswith("/A") or k.startswith("router/"))
    # at step 2 the A's of hubs whose selected slot trained at step 1 and
    # the router move (a hub that routes to a still-zero B slot does not)
    g2 = flatten_paths(ref_steps[1]["grads"])
    assert any(v.any() for k, v in g2.items() if k.endswith("/A"))
    assert all(g2[k].any() for k in ("router/w1", "router/w2"))


def test_every_hub_b_gets_its_gradient_at_step_one(setup, ref_steps):
    """No forward-only kernel sits under autograd: every hub's B gradient
    is nonzero after step 1 and the reference's (the conv sites that
    qdq_conv2d covers, which run its plain version here, among them)."""
    port = run_port(setup, steps=1)
    pg = flatten_paths(port[0]["grads"])
    rg = flatten_paths(ref_steps[0]["grads"])
    bs = [k for k in rg if k.endswith("/B")]
    assert len(bs) == len(setup["tb"].hubs)
    for k in bs:
        assert pg[k].abs().sum() > 0, k
    errs = step_errors(dict(port[0], grads={"B": {k: pg[k] for k in bs}}),
                       dict(ref_steps[0], grads={"B": {k: rg[k]
                                                      for k in bs}}),
                       {"hubs": setup["tb"].hubs, "router": setup["tb"].router})
    assert errs["grads"] <= STEP_LIMIT, errs


def test_control_faults_break_the_step_limit(setup, ref_steps, monkeypatch):
    """The 'plain' loss in place of 'dfa', and an STE without its clip
    mask: each must break STEP_LIMIT against the reference's step."""
    before = {"hubs": setup["tb"].hubs, "router": setup["tb"].router}
    plain = step_errors(run_port(setup, steps=1, loss_mode="plain")[0],
                        ref_steps[0], before)
    print("plain loss:", plain)
    assert not held(plain)
    monkeypatch.setattr(tfq._SteQdq, "backward",
                        staticmethod(lambda ctx, g: (g, None)))
    nomask = step_errors(run_port(setup, steps=1)[0], ref_steps[0], before)
    print("STE without its clip mask:", nomask)
    assert not held(nomask)


def test_finetune_and_denoising_gap_run():
    """``finetune`` (one epoch of 2 steps) and ``eval_denoising_gap`` on the
    port's own pipeline: losses and gaps finite, the hubs moved."""
    cfg = tiny_ddim(8)
    tp = tiny_unet_params(8, seed=2)[1]
    sched = tmake_schedule("linear", 50)
    calib = tpipe.build_calibration_set(tp, cfg, sched, n_samples=2,
                                        steps=2, batch=2)
    bundle = tpipe.quantize_diffusion(
        tp, cfg, sched, calib=calib, talora_cfg=ttal.TALoRAConfig(**TALORA))
    b0 = {k: v["B"].clone() for k, v in bundle.hubs.items()}
    for mode in ("learned", "split"):
        ft = tft.FinetuneConfig(steps_per_epoch=2, epochs=1, batch=2,
                                router_mode=mode)
        bundle, logs = tft.finetune(bundle, ft)
        assert np.isfinite(logs[0]["loss"])
    assert any(not torch.equal(bundle.hubs[k]["B"], b0[k]) for k in b0)
    gap = tft.eval_denoising_gap(bundle, ft, steps=2, batch=2)
    assert np.isfinite(gap["final_image_mse"]) and len(gap["step_gaps"]) == 2
    x = tpipe.sample_quantized(bundle, n=1, steps=2)
    assert x.shape == (1, 8, 8, 3) and bool(torch.isfinite(x).all())
