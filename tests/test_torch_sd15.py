"""Stable Diffusion v1.5's text-to-image UNet in the port (spatial
transformers, cross-attention to a per-row text context, guidance in one
forward) against the benchmark's plain reference
(``portbench/reference_sd15.py``, plain torch, no JAX) at a tiny size:
channels 32, one transformer level of 2 heads, a 3 x 16 context. On the
CPU every kernel wrapper takes its plain version.

Also: the presets without a context, one head and no transformer forward
as the parent's code did, op for op (``_parent_unet_apply``, the
function as it stood before the transformer was added)."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from portbench import harness, inputs
from portbench import reference_sd15 as ref
from repro_torch.common.tree import flatten_paths
from repro_torch.configs.diffusion_presets import (DIFFUSION_PRESETS,
                                                   tiny_ddim, tiny_sd)
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.nn import unet
from repro_torch.nn.embeddings import timestep_embedding
from repro_torch.nn.layers import (conv2d_apply, dense_apply,
                                   groupnorm_apply, silu)
from repro_torch.serving import DiffusionServingEngine, VirtualClock

TINY = dict(image_size=8, in_ch=4, out_ch=4, ch=32, ch_mult=[1, 2],
            num_res_blocks=1, attn_resolutions=[4], gn_groups=8,
            num_heads=2, context_dim=16, context_len=3, T=20,
            act_maxval=6.0,
            talora={"hub_size": 2, "rank": 4, "alpha": 32.0,
                    "router_hidden": 16, "t_emb_dim": 32})
SCALE = 7.5


def power_of_two_scales(params):
    """Each 4-bit weight rescaled so its abs-max is 6 * 2^k: its grid scale
    is then a power of two and the plain versions' f32 sums are exact."""
    flat = flatten_paths(params)
    for site, w in flat.items():
        if site.endswith("/w") and w.ndim >= 2 and not site.startswith(
                ("conv_in", "conv_out")):
            top = float(w.abs().max())
            target = 6.0 * 2.0 ** round(math.log2(top / 6.0))
            w.mul_(target / top)
            i = int(w.abs().argmax())
            w.view(-1)[i] = math.copysign(target, float(w.view(-1)[i]))
    return params


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    fam = harness.load_family(harness.ROOT, "sd15")
    gen = inputs.generator(7, "cpu")
    params = power_of_two_scales(fam.draw_params(TINY, gen))
    hubs, router = fam.draw_hubs(TINY, gen), fam.draw_router(TINY, gen)
    x_T = inputs.noise(TINY, gen, 4)
    ctx = fam.draw_contexts(TINY, gen, 4)
    traffic = {"process": "backlog", "max_batch": 2,
               "guidance_scale": SCALE}
    cell = harness.Cell("tiny.t2i", "tiny-sd", TINY, "t", traffic, [], [],
                        {}, harness.ROOT, fam)
    system = fam.System(cell, fam.Inputs(gen, params, hubs, router, [], x_T,
                                         ctx[:-1], ctx[-1:], []),
                        harness.Clock(), torch.device("cpu"))
    weights = ref.Weights(params, hubs, router, TINY)
    return fam, system, weights, x_T, ctx[:-1], ctx[-1:]


def test_tree_layout_matches_the_reference():
    port = flatten_paths(unet.unet_init(torch.Generator().manual_seed(0),
                                        tiny_sd()))
    ours = ref.flat_shapes(TINY)
    assert list(port) == list(ours)
    assert all(tuple(port[k].shape) == ours[k] for k in ours)
    cfg = DIFFUSION_PRESETS["sd15"]()
    full = dict(TINY, image_size=cfg.image_size, ch=cfg.ch,
                ch_mult=list(cfg.ch_mult),
                attn_resolutions=list(cfg.attn_resolutions),
                num_res_blocks=cfg.num_res_blocks,
                context_dim=cfg.context_dim)
    assert ref.n_params(full) == 859_520_964      # the published count


def test_forward_matches_the_reference(setup):
    fam, system, weights, x_T, ctx, null = setup
    bank = system.bank
    context = torch.cat([null, ctx[0:1], null, ctx[1:2]])
    for t in (2, 13):
        packed = bank.params_for_segment(bank.segment_of(t))
        tb = torch.full((4,), float(t))
        with torch.inference_mode():
            got = unet.unet_apply(packed, x_T, tb, system.ucfg,
                                  ctx=system.engine.ctx, context=context)
            want = ref.UNet(TINY)(weights.at(t), x_T, tb, context)
        assert float((got - want).norm() / want.norm()) < 1e-5
        assert float(want.abs().max()) > 0.1
        # the context reaches the output: the uncond and cond rows differ
        assert not torch.equal(got[0], got[1])


def test_attention_by_query_blocks_equals_one_block(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((3, 40, 16), generator=gen) for _ in range(3))
    whole = unet.attention(q, k, v, 4)
    monkeypatch.setattr(unet, "ATTN_BLOCK_SCORES", 3 * 4 * 40 * 7)
    blocks = unet.attention(q, k, v, 4)
    assert float((whole - blocks).abs().max()) < 1e-6
    want = ref.UNet(dict(TINY, num_heads=4))._attention(q, k, v)
    assert float((whole - want).abs().max()) < 1e-6
    # heads are not a reshape of one head
    assert float((whole - unet.attention(q, k, v, 1)).abs().max()) > 1e-3


def test_scaled_linear_schedule_matches_the_reference():
    sched = make_schedule("scaled_linear", 100)
    assert torch.equal(sched.alpha_bars, ref.alpha_bars(100))
    assert abs(float(sched.betas[0]) - 0.00085) < 1e-9
    assert abs(float(sched.betas[-1]) - 0.012) < 1e-9


def _engine(system, max_batch, x_T, ctx, null):
    return DiffusionServingEngine(
        system.ucfg, system.schedule, system.bank, act_qps=system.engine.ctx
        .act_qps, max_batch=max_batch, clock=VirtualClock(), device="cpu",
        noise_fn=lambda req: x_T[req.seed:req.seed + 1], null_context=null)


def test_a_guided_request_follows_the_reference_sampler(setup):
    fam, system, weights, x_T, ctx, null = setup
    eng = _engine(system, 2, x_T, ctx, null)
    rids = [eng.submit(steps=4, seed=i, guidance_scale=SCALE, context=ctx[i])
            for i in range(2)]
    eng.run()
    net = ref.UNet(TINY)
    for i, rid in enumerate(rids):
        s = ref.Sampler("ddim", TINY["T"], 4, x_T[i:i + 1])
        with torch.inference_mode():
            while not s.done:
                tb = torch.full((2,), float(s.t))
                e = net(weights.at(s.t), torch.cat([s.x, s.x]), tb,
                        torch.cat([null, ctx[i:i + 1]]))
                s.advance(ref.guided(e[:1], e[1:], SCALE))
        x0 = eng.results[rid].x0
        assert float((x0 - s.state).norm() / s.state.norm()) < 1e-5
    # 2 prompts x 4 steps: one forward a tick, of both prompts' two rows
    assert eng.n_forwards == 4 and eng.n_samples_batched == 16
    assert eng.stats()["guided_rows"] == 8


def test_class_labelled_guidance_keeps_its_two_partitions():
    cfg = dataclasses.replace(tiny_ddim(8), num_classes=4)
    from repro_torch.launch.serve_diffusion import TALORA_CFG
    from repro_torch.serving import WeightBank, absmax_talora_setup
    gen = torch.Generator().manual_seed(0)
    params = unet.unet_init(gen, cfg)
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=unet.io_sites(params))
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 20,
                      max_cached=20, device="cpu")
    eng = DiffusionServingEngine(cfg, make_schedule("linear", 20), bank,
                                 max_batch=2, clock=VirtualClock(),
                                 device="cpu")
    for i in range(2):
        eng.submit(steps=3, seed=i, y=i, guidance_scale=2.0)
    eng.run()
    assert eng.n_forwards == 6 and eng.n_samples_batched == 12
    assert eng.stats()["guided_rows"] == 6


def test_a_text_model_draws_each_context_from_the_seed():
    """The launcher's stand-in for the text encoder: a context drawn from
    the request's seed, a stream apart from its x_T."""
    from repro_torch.launch.serve_diffusion import drawn_context
    a, b = drawn_context(5, 16), drawn_context(5, 16)
    assert torch.equal(a, b) and a.shape == (77, 16)
    assert not torch.equal(a, drawn_context(6, 16))
    x_T = torch.randn((77, 16), generator=torch.Generator().manual_seed(5))
    assert not torch.equal(a, x_T)


def test_the_engine_takes_a_context_only_for_a_text_model(setup):
    """A text model's engine needs its null context and each request's
    own; a model without a context_dim takes neither."""
    fam, system, weights, x_T, ctx, null = setup
    with pytest.raises(ValueError, match="null_context"):
        DiffusionServingEngine(system.ucfg, system.schedule, system.bank,
                               device="cpu")
    eng = _engine(system, 2, x_T, ctx, null)
    with pytest.raises(ValueError, match="context"):
        eng.submit(steps=2, seed=0, guidance_scale=SCALE)
    cfg = tiny_ddim(8)
    from repro_torch.launch.serve_diffusion import TALORA_CFG
    from repro_torch.serving import WeightBank, absmax_talora_setup
    gen = torch.Generator().manual_seed(0)
    params = unet.unet_init(gen, cfg)
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=unet.io_sites(params))
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 20,
                      device="cpu")
    with pytest.raises(ValueError, match="null_context"):
        DiffusionServingEngine(cfg, make_schedule("linear", 20), bank,
                               device="cpu", null_context=null)
    eng = DiffusionServingEngine(cfg, make_schedule("linear", 20), bank,
                                 device="cpu")
    with pytest.raises(ValueError, match="context"):
        eng.submit(steps=2, seed=0, context=ctx[0])


@pytest.mark.parametrize("scale,rows", [(7.5, 2), (0.0, 1)])
def test_the_launcher_serves_a_text_preset(scale, rows):
    """``--preset tiny-sd``: every request guided at ``--guidance-scale``
    (0: unguided), one forward a tick of its rows."""
    from repro_torch.launch import serve_diffusion
    out = serve_diffusion.main([
        "--device", "cpu", "--preset", "tiny-sd", "--requests", "3",
        "--steps", "2", "--steps-jitter", "0", "--max-batch", "4",
        "--guidance-scale", str(scale)])
    eng = out["engine"]
    assert out["summary"]["requests"] == 3 and out["evals"] == 6
    assert eng["guided_rows"] == (6 if scale else 0)
    assert round(eng["mean_batch"] * eng["forwards"]) == 6 * rows


def _parent_attn_apply(p, x, cfg, *, ctx, site):
    b, hh, ww, c = x.shape
    h = groupnorm_apply(p["norm"], x, groups=cfg.gn_groups).reshape(b, hh * ww, c)
    q = dense_apply(p["q"], h, ctx=ctx, site=f"{site}/q")
    k = dense_apply(p["k"], h, ctx=ctx, site=f"{site}/k")
    v = dense_apply(p["v"], h, ctx=ctx, site=f"{site}/v")
    s = torch.einsum("bqc,bkc->bqk", q.to(torch.float32), k.to(torch.float32))
    w = torch.softmax(s * (c ** -0.5), dim=-1).to(v.dtype)
    o = torch.einsum("bqk,bkc->bqc", w, v)
    o = dense_apply(p["proj"], o, ctx=ctx, site=f"{site}/proj")
    return x + o.reshape(b, hh, ww, c)


def _parent_unet_apply(p, x, t, cfg, *, y=None, ctx=None):
    """``unet_apply`` as it stood before the spatial transformer."""
    temb = timestep_embedding(t, cfg.ch)
    temb = dense_apply(p["temb0"], temb, ctx=ctx, site="temb0")
    temb = dense_apply(p["temb1"], silu(temb), ctx=ctx, site="temb1")
    if cfg.num_classes and y is not None:
        temb = temb + p["class_emb"]["table"][y]
    h = conv2d_apply(p["conv_in"], x, ctx=ctx, site="conv_in")
    hs = [h]
    for i in range(len(cfg.ch_mult)):
        for j in range(cfg.num_res_blocks):
            h = unet._res_apply(p[f"down_{i}.res_{j}"], h, temb, cfg, ctx=ctx,
                                site=f"down_{i}.res_{j}")
            if f"down_{i}.attn_{j}" in p:
                h = _parent_attn_apply(p[f"down_{i}.attn_{j}"], h, cfg,
                                       ctx=ctx, site=f"down_{i}.attn_{j}")
            hs.append(h)
        if i != len(cfg.ch_mult) - 1:
            h = conv2d_apply(p[f"down_{i}.downsample"], h, stride=2, ctx=ctx,
                             site=f"down_{i}.downsample")
            hs.append(h)
    h = unet._res_apply(p["mid.res_0"], h, temb, cfg, ctx=ctx,
                        site="mid.res_0")
    h = _parent_attn_apply(p["mid.attn"], h, cfg, ctx=ctx, site="mid.attn")
    h = unet._res_apply(p["mid.res_1"], h, temb, cfg, ctx=ctx,
                        site="mid.res_1")
    for i in reversed(range(len(cfg.ch_mult))):
        for j in range(cfg.num_res_blocks + 1):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = unet._res_apply(p[f"up_{i}.res_{j}"], h, temb, cfg, ctx=ctx,
                                site=f"up_{i}.res_{j}")
            if f"up_{i}.attn_{j}" in p:
                h = _parent_attn_apply(p[f"up_{i}.attn_{j}"], h, cfg,
                                       ctx=ctx, site=f"up_{i}.attn_{j}")
        if i != 0:
            h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            h = conv2d_apply(p[f"up_{i}.upsample"], h, ctx=ctx,
                             site=f"up_{i}.upsample")
    h = silu(groupnorm_apply(p["norm_out"], h, groups=cfg.gn_groups))
    return conv2d_apply(p["conv_out"], h, ctx=ctx, site="conv_out")


@pytest.mark.parametrize("preset", ["ddim-cifar10", "ldm4-bedroom",
                                    "ldm4-imagenet"])
def test_presets_without_a_context_forward_as_the_parent(preset):
    """Each preset cut to a tiny width (its levels, attention levels and
    labels kept): the same params drawn, and the same output bit for bit,
    as the parent's ``unet_apply``, with dense weights and with packed
    W4A4 ones."""
    from repro_torch.launch.serve_diffusion import TALORA_CFG
    from repro_torch.serving import WeightBank, absmax_talora_setup
    full = DIFFUSION_PRESETS[preset]()
    cfg = dataclasses.replace(
        full, image_size=16, ch=16, gn_groups=4,
        attn_resolutions=tuple(r // (full.image_size // 16)
                               for r in full.attn_resolutions))
    assert cfg.num_heads == 1 and not cfg.context_dim
    gen = torch.Generator().manual_seed(1)
    params = unet.unet_init(gen, cfg)
    x = torch.randn((2, 16, 16, cfg.in_ch), generator=gen)
    t = torch.tensor([3.0, 17.0])
    y = torch.tensor([1, 2]) if cfg.num_classes else None
    with torch.inference_mode():
        assert torch.equal(unet.unet_apply(params, x, t, cfg, y=y),
                           _parent_unet_apply(params, x, t, cfg, y=y))
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=unet.io_sites(params))
    bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 20,
                      max_cached=2, device="cpu")
    eng = DiffusionServingEngine(cfg, make_schedule("linear", 20), bank,
                                 device="cpu")
    packed = bank.params_for_segment(bank.segment_of(3))
    with torch.inference_mode():
        assert torch.equal(
            unet.unet_apply(packed, x, t, cfg, y=y, ctx=eng.ctx),
            _parent_unet_apply(packed, x, t, cfg, y=y, ctx=eng.ctx))
