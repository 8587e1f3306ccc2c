"""The UNet family: the paper's W4A4 MSFP diffusion UNet eps-predictor,
served by the port's ``repro_torch.serving.DiffusionServingEngine``.

Model: ``repro_torch.nn.unet`` at the configuration's sizes
(``_unet_config``), built as ``launch/serve_diffusion.py`` builds it (the
abs-max FP4 plan, TALoRA hubs and router, E2M1 acts, policy ``fifo``, the
implicit conv route, no obs), with a weight bank that can hold every
routing segment. Set-up builds every segment under open-loop traffic,
and under a backlog those its requests' timesteps route to. ``draw``
takes its parameters, hubs, router, requests and each request's x_T
from the seed (``inputs``, ``loadgen``); ``flops`` counts its work.

Reference: ``reference.UNet`` and ``reference.Weights`` (this UNet, its
TALoRA merge and its FP4 grid, in plain PyTorch); ``reference.Sampler``
and ``reference.n_evals`` are the samplers', which any diffusion family
reuses.

Checks (``check``): ``trajectory_gap``, the samplers' stage, held for any
diffusion family by ``check.trajectory_gap``; and ``layer_gap``, this
UNet's stage, one forward replayed op by op through the reference's glue
by ``check.layer_gap``.

The engine is watched through two seams: its ``apply_fn`` (``Recorder``:
the model call itself, noting what the comparison needs) and the
batcher's ``select`` (which requests a forward's rows hold).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from portbench import check, flops, inputs, loadgen, reference
from portbench.harness import TAIL_S, sync

# K3 and K2 share one tensor-core body (``w4_gemm_kernel``, with its
# split-K ``splitk_reduce``), told apart by the act loader it is built
# with: ``ConvA`` (K3 ``w4a4_conv2d``) or ``DenseA`` (K2 ``w4a4_matmul``).
# Both fragments have to appear: ``qdq_conv2d_kernel`` takes a ``ConvArgs``.
KERNELS = {r"^(?=.*(?:w4_gemm_kernel|splitk_reduce))(?=.*ConvA)": "K3",
           r"^(?=.*(?:w4_gemm_kernel|splitk_reduce))(?=.*DenseA)": "K2"}

kernel_bound_seconds = flops.kernel_bound_seconds


def flops_per_eval(cfg: dict) -> int:
    return flops.model_flops(cfg, 1)


def evals_per_image(cell, reqs: list) -> float:
    """Mean evals an image takes over ``reqs`` (the window's)."""
    return float(np.mean([reference.n_evals(r.sampler, cell.cfg["T"],
                                            r.steps) for r in reqs]))


def _unet_config(cfg: dict):
    from repro_torch.nn.unet import UNetConfig
    return UNetConfig(image_size=cfg["image_size"], in_ch=cfg["in_ch"],
                      out_ch=cfg["out_ch"], ch=cfg["ch"],
                      ch_mult=tuple(cfg["ch_mult"]),
                      num_res_blocks=cfg["num_res_blocks"],
                      attn_resolutions=tuple(cfg["attn_resolutions"]),
                      gn_groups=cfg["gn_groups"])


class Recorder:
    """The engine's model call (its ``apply_fn`` seam): ``unet_apply``
    itself, noting for the comparison, without a synchronise, the input,
    timestep and eps rows of the sampled requests at every forward; and
    once asked (``capture``), the first and last rows of every conv, dense
    and GroupNorm call of one forward."""

    def __init__(self, ucfg, sampled: set):
        self.ucfg = ucfg
        self.sampled = sampled
        self.members: list = []
        self.records = collections.defaultdict(list)
        self.capture = False
        self.captured: dict | None = None

    def select(self, select):
        """Wrap the batcher's ``select`` to learn each forward's rows: one
        partition (no class labels), rows in the members' order."""
        def recording_select(*args, **kw):
            seg, self.members = select(*args, **kw)
            return seg, self.members
        return recording_select

    def __call__(self, params, x, tb, y, ctx):
        from repro_torch.nn import unet
        if not self.capture:
            eps = unet.unet_apply(params, x, tb, self.ucfg, y=y, ctx=ctx)
        else:
            eps = self._captured_forward(unet, params, x, tb, y, ctx)
        for j, rs in enumerate(self.members[:x.shape[0]]):
            if rs.req.seed in self.sampled:
                self.records[rs.req.seed].append(
                    (tb[j:j + 1].clone(), x[j:j + 1].clone(),
                     eps[j:j + 1].clone()))
        return eps

    def _captured_forward(self, unet, params, x, tb, y, ctx):
        rows = torch.tensor(sorted({0, x.shape[0] - 1}), device=x.device)
        ops, saved = [], {}
        for name in ("conv2d_apply", "dense_apply", "groupnorm_apply"):
            fn = saved[name] = getattr(unet, name)

            def rec(p, xx, _fn=fn, **kw):
                out = _fn(p, xx, **kw)
                ops.append((xx[rows].float(), out[rows].float()))
                return out
            setattr(unet, name, rec)
        try:
            eps = unet.unet_apply(params, x, tb, self.ucfg, y=y, ctx=ctx)
        finally:
            for name, fn in saved.items():
                setattr(unet, name, fn)
        self.capture = False
        self.captured = {"x": x[rows].clone(), "t": tb[rows].clone(),
                         "eps": eps[rows].clone(), "ops": ops}
        return eps


@dataclasses.dataclass
class Inputs:
    """What a run draws from its seed: the generator (on the device), the
    weights, the TALoRA hubs and router, the requests, each request's x_T
    and the requests the comparison follows."""
    gen: torch.Generator
    params: dict
    hubs: dict
    router: dict
    reqs: list
    x_T: torch.Tensor
    follow: list


class System:
    """The port, built for one cell from the drawn inputs."""

    def __init__(self, cell, drawn: Inputs, clock, device):
        from repro_torch.common.tree import flatten_paths
        from repro_torch.core import talora
        from repro_torch.diffusion.schedule import make_schedule
        from repro_torch.kernels import ops
        from repro_torch.nn.unet import io_sites
        from repro_torch.quant.fakequant import (KIND_FP_SIGNED,
                                                 QuantizerParams)
        from repro_torch.serving import (DiffusionServingEngine, WeightBank,
                                         default_serving_plan)
        from repro_torch.serving.obs import NULL_OBS
        cfg = cell.cfg
        ops.CONV_ROUTE = "implicit"
        self.cell, self.device, self.drawn = cell, device, drawn
        self.reqs, self.follow = drawn.reqs, sorted(drawn.follow)
        params, x_T = drawn.params, drawn.x_T
        self.ucfg = _unet_config(cfg)
        self.schedule = make_schedule("linear", cfg["T"])
        weights = {k: v for k, v in flatten_paths(params).items()
                   if k.endswith("/w") and v.ndim >= 2}
        plan = default_serving_plan(weights, io_sites=io_sites(params))
        self.bank = WeightBank(params, plan, drawn.hubs, drawn.router,
                               talora.TALoRAConfig(**cfg["talora"]), cfg["T"],
                               max_cached=cfg["T"], device=device)
        act = QuantizerParams(KIND_FP_SIGNED, 2, 1, 4, torch.tensor(
            float(cfg["act_maxval"]), device=device))
        sampled = set(drawn.follow)

        def new_engine(max_batch: int, clock):
            self.recorder = Recorder(self.ucfg, sampled)
            eng = DiffusionServingEngine(
                self.ucfg, self.schedule, self.bank,
                act_qps={"*": act}, apply_fn=self.recorder,
                max_batch=max_batch, policy="fifo", now_fn=clock.now,
                obs=NULL_OBS, device=device,
                noise_fn=lambda req: x_T[req.seed:req.seed + 1])
            eng.batcher.select = self.recorder.select(eng.batcher.select)
            return eng

        self.new_engine = new_engine
        self.engine = new_engine(cell.traffic["max_batch"], clock)

    def segments(self) -> list[int]:
        """The segments set-up builds: every one under open-loop traffic,
        which cannot be foreseen; under a backlog, whose whole queue is
        known, those that its requests' timesteps route to, by the
        program's own samplers."""
        from repro_torch.diffusion.samplers import (sampler_advance,
                                                    sampler_init,
                                                    sampler_needed_t)
        if self.cell.traffic["process"] != "backlog":
            return list(range(self.bank.n_segments))
        ts = set()
        for kind, steps in {(r.sampler, r.steps) for r in self.reqs}:
            st = sampler_init(kind, self.schedule, (1, 1, 1, 1),
                              steps=steps, x_T=torch.zeros(1, 1, 1, 1))
            while not st.done:
                ts.add(sampler_needed_t(st))
                sampler_advance(st, torch.zeros(1, 1, 1, 1))
        return sorted({self.bank.segment_of(t) for t in ts})

    def build_segments(self, segments: list[int]) -> None:
        for s in segments:
            self.bank.prefetch(s, block=True)
        sync(self.device)

    def warm(self, buckets: list[int], seg: int,
             gen: torch.Generator) -> None:
        """One forward at each batch bucket the traffic runs, on segment
        ``seg``'s weights."""
        from repro_torch.nn.unet import unet_apply
        params = self.bank.params_for_segment(seg)
        s, c = self.ucfg.image_size, self.ucfg.in_ch
        for b in buckets:
            x = torch.randn((b, s, s, c), generator=gen, device=gen.device)
            tb = (torch.arange(b, device=gen.device) % self.bank.T).float()
            with torch.inference_mode():
                unet_apply(params, x, tb, self.ucfg, ctx=self.engine.ctx)
        sync(self.device)

    def set_up(self) -> float:
        """The segments' builds, then a warm forward a batch bucket;
        returns the builds' seconds."""
        segments = self.segments()
        t0 = time.perf_counter()
        self.build_segments(segments)
        bank_build_s = time.perf_counter() - t0
        self.warm(loadgen.buckets(self.cell.traffic), segments[0],
                  self.drawn.gen)
        return bank_build_s

    def submit(self, r: loadgen.Request) -> int:
        return self.engine.submit(steps=r.steps, eta=r.eta, seed=r.index,
                                  sampler=r.sampler, arrival=r.due)

    def close(self) -> None:
        """The window has closed: record the next forward op by op."""
        rec = self.recorder
        rec.capture = rec.captured is None

    def ready(self, follow: set) -> bool:
        """That forward recorded, and every request in ``follow`` done."""
        return (self.recorder.captured is not None
                and follow <= {rs.req.seed
                               for rs in self.engine.results.values()})


def sample_of(cell, reqs: list, seed: int) -> list[int]:
    """The requests the comparison follows, drawn from the seed before the
    run: from a backlog's first batch, or from the requests due in the
    window's first third with the one of most evals among them; both
    finish within the window even where the queue grows (at twice the
    knee a request due at d finishes near 2d plus its own service)."""
    T = cell.cfg["T"]
    if cell.traffic["process"] == "backlog":
        cand = [r.index for r in reqs[:cell.traffic["max_batch"]]]
        return check.pick(cand, {}, seed, longest=False)
    third = max(r.due for r in reqs if r.in_window) / 3
    evals = {r.index: reference.n_evals(r.sampler, T, r.steps)
             for r in reqs if r.in_window and r.due <= third}
    return check.pick(list(evals), evals, seed, longest=True)


def draw(cell, seed: int, seconds: float, device) -> Inputs:
    """The inputs drawn from the seed, in this order: weights, hubs,
    router, then the requests and each request's x_T; and the followed
    sample."""
    cfg, traffic = cell.cfg, cell.traffic
    gen = inputs.generator(seed, device)
    params = inputs.params(cfg, gen)
    hubs = inputs.hubs(cfg, gen)
    router = inputs.router(cfg, gen)
    reqs = loadgen.generate(traffic, seed, seconds,
                            TAIL_S if traffic["process"] != "backlog" else 0)
    x_T = inputs.noise(cfg, gen, len(reqs))
    return Inputs(gen, params, hubs, router, reqs, x_T,
                  sample_of(cell, reqs, seed))


def build(cell, seed: int, seconds: float, device, clock) -> System:
    """The port, built from the inputs drawn from the seed."""
    return System(cell, draw(cell, seed, seconds, device), clock, device)


def compare(system: System) -> dict:
    """Frees the engine and its bank, then holds the followed requests'
    trajectories and the recorded forward against the reference."""
    cfg, drawn = system.cell.cfg, system.drawn
    by_index = {rs.req.seed: rs for rs in system.engine.results.values()}
    answers = {i: by_index[i].x0 for i in system.follow
               if i in by_index and by_index[i].x0 is not None}
    rec = system.recorder
    del by_index
    system.bank = system.engine = None
    gc.collect()
    if system.device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    spec = {r.index: r for r in system.reqs}
    weights = reference.Weights(drawn.params, drawn.hubs, drawn.router, cfg)
    checks = {
        "trajectory_gap": check.trajectory_gap(
            cfg, [spec[i] for i in system.follow], drawn.x_T, rec.records,
            answers),
        "layer_gap": (check.layer_gap(cfg, weights, rec.captured)
                      if rec.captured is not None else float("inf"))}
    print(f"reference: {len(system.follow)} trajectories and one forward "
          f"in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return checks
