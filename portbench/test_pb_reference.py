"""The plain reference against the port's plain path on tiny-ddim (the
port on the CPU takes every kernel's plain version)."""
import ast
import json
import math
import pathlib

import pytest
import torch

from portbench import harness, inputs, reference

HERE = pathlib.Path(__file__).resolve().parent


def tiny_cfg():
    cfg = json.loads((HERE / "configs" / "ddim-cifar10.json").read_text())
    cfg.update(image_size=8, ch=32, ch_mult=[1, 2], num_res_blocks=1,
               attn_resolutions=[4], gn_groups=8, T=20)
    return cfg


def power_of_two_scales(params):
    """Each 4-bit weight rescaled so its abs-max is 6 * 2^k: the grid scale
    is then a power of two and the plain versions' f32 sums are exact."""
    for site in list(reference.flatten(params)):
        if site.endswith("/w") and site.rsplit("/", 1)[0] not in \
                reference.IO_SITES:
            mod, leaf = site.rsplit("/", 1)
            node = params
            for m in mod.split("/"):
                node = node[m]
            w = node[leaf]
            top = float(w.abs().max())
            target = 6.0 * 2.0 ** round(math.log2(top / 6.0))
            w = w / top * target
            i = int(w.abs().argmax())
            w.view(-1)[i] = math.copysign(target, float(w.view(-1)[i]))
            node[leaf] = w
    return params


@pytest.fixture(scope="module")
def setup():
    from repro_torch.diffusion.schedule import make_schedule
    cfg = tiny_cfg()
    gen = inputs.generator(5, "cpu")
    params = power_of_two_scales(inputs.params(cfg, gen))
    hubs, router = inputs.hubs(cfg, gen), inputs.router(cfg, gen)
    x_T = inputs.noise(cfg, gen, 4)
    cell = harness.Cell("tiny", "tiny", cfg, "t", {"max_batch": 4}, [], [],
                        {}, harness.ROOT)
    unet = harness.load_family(harness.ROOT, "unet")
    system = unet.System(cell, unet.Inputs(gen, params, hubs, router, [],
                                           x_T, []),
                         harness.Clock(), torch.device("cpu"))
    return cfg, params, hubs, router, x_T, system, make_schedule(
        "linear", cfg["T"])


def test_tree_layout_matches_the_port(setup):
    from repro_torch.common.tree import flatten_paths
    from repro_torch.configs.diffusion_presets import tiny_ddim
    from repro_torch.nn.unet import unet_init
    port = flatten_paths(unet_init(torch.Generator().manual_seed(0),
                                   tiny_ddim(8)))
    ours = reference.flat_shapes(tiny_cfg())
    assert list(port) == list(ours)
    assert all(tuple(port[k].shape) == ours[k] for k in ours)


def test_merged_and_packed_weights_equal_the_bank(setup):
    from repro_torch.core.qmodule import PackedW4, dequant_weight
    from repro_torch.common.tree import flatten_paths
    cfg, params, hubs, router, _, system, _ = setup
    bank = system.bank
    weights = reference.Weights(params, hubs, router, cfg)
    assert weights.n_segments() == bank.n_segments
    assert (weights.slots == bank.signatures).all()
    for t in (0, 7, cfg["T"] - 1):
        packed = flatten_paths(bank.params_for_segment(bank.segment_of(t)))
        ours = weights.at(t)
        for site in reference.weight_sites(cfg):
            got = packed[site]
            if isinstance(got, PackedW4):
                kind, g, s = ours[site]
                assert kind == "q"
                want = (g * s).reshape(got.shape)
                assert torch.equal(dequant_weight(got, torch.float32), want)
            else:
                kind, w = ours[site]
                assert kind == "io"
                assert torch.equal(got.float(), w)


def test_forward_equals_the_port(setup):
    from repro_torch.nn.unet import unet_apply
    cfg, params, hubs, router, x_T, system, _ = setup
    bank = system.bank
    t = torch.tensor([3.0, 11.0, 11.0, 19.0])
    weights = reference.Weights(params, hubs, router, cfg)
    for tt in (3, 11):
        packed = bank.params_for_segment(bank.segment_of(tt))
        x = x_T[:4]
        with torch.inference_mode():
            got = unet_apply(packed, x, torch.full_like(t, tt), system.ucfg,
                             ctx=system.engine.ctx)
            want = reference.UNet(cfg)(weights.at(tt), x,
                                       torch.full_like(t, tt))
        assert torch.equal(got, want)
        assert float(want.abs().max()) > 0.1


@pytest.mark.parametrize("kind", ["ddim", "plms", "dpm_solver2"])
def test_each_sampler_steps_as_the_port(setup, kind):
    from repro_torch.diffusion.samplers import (sampler_advance,
                                                sampler_init,
                                                sampler_needed_t)
    cfg, _, _, _, x_T, _, sched = setup
    steps = 7
    port = sampler_init(kind, sched, (1, 8, 8, 3), steps=steps,
                        x_T=x_T[:1])
    ours = reference.Sampler(kind, cfg["T"], steps, x_T[:1])
    gen = torch.Generator().manual_seed(1)
    n = 0
    while not port.done:
        assert sampler_needed_t(port) == ours.t
        assert torch.equal(port.eval_x, ours.x)
        eps = torch.randn(port.x.shape, generator=gen)
        sampler_advance(port, eps)
        ours.advance(eps)
        n += 1
        assert ours.done == port.done
    assert n == reference.n_evals(kind, cfg["T"], steps)
    assert torch.equal(port.x, ours.state)


def test_ddim_with_noise_steps_as_the_port_group_advance(setup):
    """At eta 1 the port's group advance, the path the cells time, draws
    each row's noise from the row's seed; the reference draws it again."""
    from repro_torch.diffusion.samplers import (sampler_advance_group,
                                                sampler_init)
    cfg, _, _, _, x_T, _, sched = setup
    seeds = (3, 11, 2**31 + 5)
    port = [sampler_init("ddim", sched, (1, 8, 8, 3), steps=6, eta=1.0,
                         seed=s, x_T=x_T[i:i + 1])
            for i, s in enumerate(seeds)]
    ours = [reference.Sampler("ddim", cfg["T"], 6, x_T[i:i + 1], eta=1.0,
                              seed=s) for i, s in enumerate(seeds)]
    gen = torch.Generator().manual_seed(2)
    while not port[0].done:
        for p, o in zip(port, ours):
            assert torch.equal(p.x, o.x)
        eps = torch.randn((3, 8, 8, 3), generator=gen)
        sampler_advance_group(port, eps)
        for o, e in zip(ours, eps.split(1)):
            o.advance(e)
    assert all(o.done for o in ours)
    for p, o in zip(port, ours):
        assert torch.equal(p.x, o.state)
    plain = reference.Sampler("ddim", cfg["T"], 6, x_T[:1])
    for e in torch.randn((6, 1, 8, 8, 3), generator=gen):
        plain.advance(e)
    assert not torch.equal(plain.state, ours[0].state)


def test_reference_imports_torch_and_numpy_only():
    tree = ast.parse((HERE / "reference.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}, names
