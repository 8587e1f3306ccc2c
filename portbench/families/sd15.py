"""The ``sd15`` family: Stable Diffusion v1.5's text-to-image UNet, W4A4
MSFP, served with classifier-free guidance by the port's
``repro_torch.serving.DiffusionServingEngine``.

Model: ``repro_torch.nn.unet`` with spatial transformers (a
``UNetConfig.context_dim``) at the configuration's sizes, on the
``scaled_linear`` schedule, built as ``launch/serve_diffusion.py`` builds
it (the abs-max FP4 plan, TALoRA hubs and router, E2M1 acts, policy
``fifo``, the implicit conv route, no obs), with a weight bank that can
hold every routing segment; set-up builds the segments a backlog's
timesteps route to (every one under open-loop traffic). Each request
brings a text context drawn from the seed and the traffic's
``guidance_scale``; its uncond row takes the null prompt's context, also
drawn from the seed, and both rows run in one forward.

``draw`` takes, from the seed and in this order, the parameters, the
TALoRA hubs and router, each request's x_T, each request's context and
the null context; ``layers`` counts the work.

Reference: ``reference_sd15`` (this UNet, guidance, DDIM on its
schedule; the merge and FP4 grid of ``reference``).

Checks, both held at the cell's limits:

``trajectory_gap``: for a sample of the requests (``check.pick``), the
reference's sampler from the same x_T fed at each eval the program's
uncond and cond eps of that request, combined at the traffic's scale,
against the latent the program evaluated on both rows and the x0 it
returned; an eval missing a row, out of order or mistimed reads inf.

``layer_gap``: one forward (the first after the window) recorded op by
op: the batch's first and last row of every conv, dense, GroupNorm,
LayerNorm, attention call (its q, k and v) and GEGLU. The reference
computes each op from the program's input against the program's output,
and each input from the program's earlier outputs by its own glue, with
each row's context its own: the null context for an uncond row, the
request's drawn context otherwise. Besides, every row's input to each
cross-attention's k and v projection is held against the context that
row's (seed, role) should get; so a row served another context, or the
uncond and cond contexts swapped, is a gap wherever in the batch it is.

The engine is watched through two seams: its ``apply_fn`` (``Recorder``)
and the batcher's ``select`` (the forward's members; each guided member
holds two rows, uncond then cond, in the members' order).
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import check, flops, inputs, loadgen, reference
from portbench import reference_sd15 as ref
from portbench.families import unet as unet_family
from portbench.harness import TAIL_S, sync

# K3 and K2 as in ``families/unet.py``; ATT: the attention's products and
# softmax, cuBLAS's f32 GEMMs and the softmax kernel (every dense site is
# K2; the one f32 product besides, ``conv_out``'s, where ``qdq_conv2d``
# does not cover it, is a cuDNN convolution, kept out by its name). The
# first pattern that matches counts.
KERNELS = {r"^(?=.*(?:w4_gemm_kernel|splitk_reduce))(?=.*ConvA)": "K3",
           r"^(?=.*(?:w4_gemm_kernel|splitk_reduce))(?=.*DenseA)": "K2",
           r"(?i)^(?!.*(?:conv|fprop))(?=.*(?:gemm|softmax|splitkreduce))":
           "ATT"}

# f32 CUDA-core peak of one H100 SXM (data sheet): the attention's bound
PEAK_F32_FLOPS = 67e12
UNCOND, COND, PLAIN = "u", "c", "p"


@dataclasses.dataclass(frozen=True)
class Attn:
    """One attention call of a forward: ``batch`` rows of ``nq`` queries
    over ``nk`` keys, ``c`` channels over all heads."""
    site: str
    batch: int
    nq: int
    nk: int
    c: int
    kernel: str = "ATT"

    @property
    def flops(self) -> int:      # q k^T and p v: nq x nk x c MACs each
        return 2 * 2 * self.batch * self.nq * self.nk * self.c

    @property
    def bytes(self) -> int:      # f32 q, k, v read and out written once
        return flops.F32 * self.batch * self.c * (2 * self.nq + 2 * self.nk)


def layers(cfg: dict, batch: int) -> list:
    """Every product of one forward at ``batch`` rows: ``flops.Layer`` for
    each conv and dense layer, ``Attn`` for each attention call."""
    ch, temb, ctx = cfg["ch"], 4 * cfg["ch"], cfg["context_dim"]
    n_ctx = cfg["context_len"]
    out: list = []

    def conv(site, res, cin, cout, k=3, stride=1, io=False):
        o = -(-res // stride)
        out.append(flops.Layer(site, "conv", batch * o * o, k * k * cin, cout,
                               io, batch * res * res, cin))

    def dense(site, rows, din, dout):
        out.append(flops.Layer(site, "dense", rows, din, dout))

    def res_block(site, res, cin, cout):
        conv(f"{site}/conv1", res, cin, cout)
        dense(f"{site}/temb", batch, temb, cout)
        conv(f"{site}/conv2", res, cout, cout)
        if cin != cout:
            conv(f"{site}/skip", res, cin, cout, k=1)

    def transformer(site, res, c):
        n = res * res
        rows = batch * n
        conv(f"{site}/proj_in", res, c, c, k=1)
        for a, nk, c_kv in (("attn1", n, c), ("attn2", n_ctx, ctx)):
            dense(f"{site}/{a}/q", rows, c, c)
            dense(f"{site}/{a}/k", batch * nk, c_kv, c)
            dense(f"{site}/{a}/v", batch * nk, c_kv, c)
            out.append(Attn(f"{site}/{a}", batch, n, nk, c))
            dense(f"{site}/{a}/out", rows, c, c)
        dense(f"{site}/ff/proj", rows, c, 8 * c)
        dense(f"{site}/ff/out", rows, 4 * c, c)
        conv(f"{site}/proj_out", res, c, c, k=1)

    dense("temb0", batch, ch, temb)
    dense("temb1", batch, temb, temb)
    res = cfg["image_size"]
    conv("conv_in", res, cfg["in_ch"], ch, io=True)
    chans, c_cur, mults = [ch], ch, cfg["ch_mult"]
    for i, mult in enumerate(mults):
        for j in range(cfg["num_res_blocks"]):
            res_block(f"down_{i}.res_{j}", res, c_cur, ch * mult)
            c_cur = ch * mult
            if res in cfg["attn_resolutions"]:
                transformer(f"down_{i}.attn_{j}", res, c_cur)
            chans.append(c_cur)
        if i != len(mults) - 1:
            conv(f"down_{i}.downsample", res, c_cur, c_cur, stride=2)
            res //= 2
            chans.append(c_cur)
    res_block("mid.res_0", res, c_cur, c_cur)
    transformer("mid.attn", res, c_cur)
    res_block("mid.res_1", res, c_cur, c_cur)
    for i in reversed(range(len(mults))):
        for j in range(cfg["num_res_blocks"] + 1):
            res_block(f"up_{i}.res_{j}", res, c_cur + chans.pop(),
                      ch * mults[i])
            c_cur = ch * mults[i]
            if res in cfg["attn_resolutions"]:
                transformer(f"up_{i}.attn_{j}", res, c_cur)
        if i != 0:
            res *= 2
            conv(f"up_{i}.upsample", res, c_cur, c_cur)
    conv("conv_out", res, c_cur, cfg["out_ch"], io=True)
    return out


def flops_per_eval(cfg: dict) -> int:
    return sum(layer.flops for layer in layers(cfg, 1))


def _bound(layer) -> float:
    if isinstance(layer, Attn):
        return max(layer.flops / PEAK_F32_FLOPS,
                   layer.bytes / flops.PEAK_BYTES)
    return flops.bound_seconds(layer)


def kernel_bound_seconds(cfg: dict, kernel: str, batch: int) -> float:
    """Sum of the bounds of one forward's work of ``kernel`` (K2, K3 or
    ATT) at ``batch`` rows (padding included): operations at the peak
    (989 TFLOP/s for K2 and K3, the f32 67 TFLOP/s for ATT) or bytes at
    3.35 TB/s, whichever is longer, call by call."""
    return sum(_bound(layer) for layer in layers(cfg, batch)
               if layer.kernel == kernel)


def evals_per_image(cell, reqs: list) -> float:
    """Mean rows an image takes over ``reqs`` (the window's): its
    sampler's evals, twice where the traffic guides."""
    rows = 2 if cell.traffic.get("guidance_scale", 0.0) > 0 else 1
    return float(np.mean([rows * reference.n_evals(r.sampler, cell.cfg["T"],
                                                   r.steps) for r in reqs]))


def _unet_config(cfg: dict):
    from repro_torch.nn.unet import UNetConfig
    return UNetConfig(image_size=cfg["image_size"], in_ch=cfg["in_ch"],
                      out_ch=cfg["out_ch"], ch=cfg["ch"],
                      ch_mult=tuple(cfg["ch_mult"]),
                      num_res_blocks=cfg["num_res_blocks"],
                      attn_resolutions=tuple(cfg["attn_resolutions"]),
                      gn_groups=cfg["gn_groups"],
                      num_heads=cfg["num_heads"],
                      context_dim=cfg["context_dim"])


# the ops of one forward that ``layer_gap`` holds: the names the UNet calls
CAPTURED = ("conv2d_apply", "dense_apply", "groupnorm_apply",
            "layernorm_apply", "attention", "geglu")
# the sites whose input is the rows' text context: every row is held
CROSS_KV = ("/attn2/k", "/attn2/v")


class Recorder:
    """The engine's model call (its ``apply_fn`` seam): ``unet_apply``
    itself, noting for the comparison, without a synchronise, the role,
    timestep, input and eps rows of the sampled requests at every
    forward; and once asked (``capture``), the first and last rows of
    every op of ``CAPTURED`` in one forward, and every row of the inputs
    of its cross-attentions' k and v projections."""

    def __init__(self, ucfg, sampled: set):
        self.ucfg = ucfg
        self.sampled = sampled
        self.members: list = []
        self.records = collections.defaultdict(list)
        self.capture = False
        self.captured: dict | None = None

    select = unet_family.Recorder.select

    def rows(self) -> list[tuple[int, str]]:
        """(request seed, role) of each row of the forward: a guided
        member's uncond then cond row, a plain member's one row."""
        out = []
        for rs in self.members:
            if rs.req.guidance_scale > 0:
                out += [(rs.req.seed, UNCOND), (rs.req.seed, COND)]
            else:
                out.append((rs.req.seed, PLAIN))
        return out

    def __call__(self, params, x, tb, y, ctx, context=None):
        from repro_torch.nn import unet
        rows = self.rows()
        if not self.capture:
            eps = unet.unet_apply(params, x, tb, self.ucfg, y=y, ctx=ctx,
                                  context=context)
        else:
            eps = self._captured_forward(unet, params, x, tb, y, ctx,
                                         context, rows)
        for j, (seed, role) in enumerate(rows[:x.shape[0]]):
            if seed in self.sampled:
                self.records[seed].append(
                    (role, tb[j:j + 1].clone(), x[j:j + 1].clone(),
                     eps[j:j + 1].clone()))
        return eps

    def _captured_forward(self, unet, params, x, tb, y, ctx, context, rows):
        n = min(len(rows), x.shape[0])
        idx = sorted({0, n - 1})
        at = torch.tensor(idx, device=x.device)
        ops, kv, saved = [], [], {}

        def take(t):
            return (tuple(v[at].float() for v in t) if isinstance(t, tuple)
                    else t[at].float())
        for name in CAPTURED:
            fn = saved[name] = getattr(unet, name)

            def rec(*args, _fn=fn, _name=name, **kw):
                out = _fn(*args, **kw)
                if kw.get("site", "").endswith(CROSS_KV):
                    kv.append(args[1][:n].float())
                if _name == "attention":
                    ins = tuple(args[:3])
                elif _name == "geglu":
                    ins = args[0]
                else:
                    ins = args[1]
                ops.append((_name, take(ins), take(out)))
                return out
            setattr(unet, name, rec)
        try:
            eps = unet.unet_apply(params, x, tb, self.ucfg, y=y, ctx=ctx,
                                  context=context)
        finally:
            for name, fn in saved.items():
                setattr(unet, name, fn)
        self.capture = False
        self.captured = {"x": x[at].clone(), "t": tb[at].clone(),
                         "eps": eps[at].clone(), "ops": ops,
                         "rows": [rows[i] for i in idx],
                         "kv": kv, "kv_rows": rows[:n]}
        return eps


@dataclasses.dataclass
class Inputs:
    """What a run draws from its seed: the generator (on the device), the
    weights, the TALoRA hubs and router, the requests, each request's x_T
    and text context, the null context and the requests the comparison
    follows."""
    gen: torch.Generator
    params: dict
    hubs: dict
    router: dict
    reqs: list
    x_T: torch.Tensor
    contexts: torch.Tensor
    null_context: torch.Tensor
    follow: list


def draw_params(cfg: dict, gen: torch.Generator) -> dict:
    """Every conv and dense weight at its fan-in scale, norms' gains near
    1, biases near 0 (as ``inputs.params`` draws the UNet family's)."""
    shapes = ref.flat_shapes(cfg)
    draws = inputs._draw(gen, [math.prod(s) for s in shapes.values()])
    flat = {}
    for (path, shape), d in zip(shapes.items(), draws):
        d = d.reshape(shape)
        leaf = path.rsplit("/", 1)[1]
        if leaf == "w":
            flat[path] = d * math.prod(shape[:-1]) ** -0.5
        elif leaf == "g":
            flat[path] = 1.0 + 0.1 * d
        else:
            flat[path] = 0.1 * d
    return inputs._nest(flat)


def draw_hubs(cfg: dict, gen: torch.Generator) -> dict:
    """Each site's adapters as ``inputs.hubs`` draws them: ``B`` drawn so
    that segments differ by about 5% of a weight's spread."""
    tal = cfg["talora"]
    h, r = tal["hub_size"], tal["rank"]
    shapes = ref.flat_shapes(cfg)
    dims = {site: (math.prod(shapes[site][:-1]), shapes[site][-1])
            for site in ref.weight_sites(cfg)}
    a = inputs._draw(gen, [h * din * r for din, _ in dims.values()])
    b = inputs._draw(gen, [h * r * dout for _, dout in dims.values()])
    b_scale = 0.05 * r / tal["alpha"]
    return {site: {"A": ai.reshape(h, din, r) * r ** -0.5,
                   "B": bi.reshape(h, r, dout) * (b_scale * din ** -0.5)}
            for (site, (din, dout)), ai, bi in zip(dims.items(), a, b)}


def draw_router(cfg: dict, gen: torch.Generator) -> dict:
    tal = cfg["talora"]
    d, hid = tal["t_emb_dim"], tal["router_hidden"]
    out = len(ref.weight_sites(cfg)) * tal["hub_size"]
    w1, b1, w2, b2 = inputs._draw(gen, [d * hid, hid, hid * out, out])
    return {"w1": w1.reshape(d, hid) * d ** -0.5, "b1": 0.1 * b1,
            "w2": w2.reshape(hid, out) * hid ** -0.5, "b2": 0.1 * b2}


def draw_contexts(cfg: dict, gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, L, D): row i the text context of the request of index i; row n
    the null prompt's."""
    return torch.randn((n + 1, cfg["context_len"], cfg["context_dim"]),
                       generator=gen, device=gen.device)


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
        self.scale = float(cell.traffic.get("guidance_scale", 0.0))
        params, x_T = drawn.params, drawn.x_T
        self.ucfg = _unet_config(cfg)
        self.schedule = make_schedule("scaled_linear", cfg["T"])
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
                noise_fn=lambda req: x_T[req.seed:req.seed + 1],
                null_context=drawn.null_context)
            eng.batcher.select = self.recorder.select(eng.batcher.select)
            return eng

        self.new_engine = new_engine
        self.engine = new_engine(cell.traffic["max_batch"], clock)

    segments = unet_family.System.segments

    def set_up(self) -> float:
        """The segments' builds, then one warm forward a batch bucket of
        rows (a guided request's two rows each); returns the builds'
        seconds."""
        from repro_torch.nn.unet import unet_apply
        segments = self.segments()
        t0 = time.perf_counter()
        for s in segments:
            self.bank.prefetch(s, block=True)
        sync(self.device)
        bank_build_s = time.perf_counter() - t0
        params = self.bank.params_for_segment(segments[0])
        traffic = dict(self.cell.traffic)
        rows = 2 if self.scale > 0 else 1
        traffic["max_batch"] = rows * traffic["max_batch"]
        s, c, gen = self.ucfg.image_size, self.ucfg.in_ch, self.drawn.gen
        for b in loadgen.buckets(traffic):
            x = torch.randn((b, s, s, c), generator=gen, device=gen.device)
            tb = (torch.arange(b, device=gen.device) % self.bank.T).float()
            ctx = self.drawn.contexts[:1].expand(b, -1, -1)
            with torch.inference_mode():
                unet_apply(params, x, tb, self.ucfg, ctx=self.engine.ctx,
                           context=ctx)
        sync(self.device)
        return bank_build_s

    def submit(self, r: loadgen.Request) -> int:
        return self.engine.submit(steps=r.steps, eta=r.eta, seed=r.index,
                                  sampler=r.sampler, arrival=r.due,
                                  guidance_scale=self.scale,
                                  context=self.drawn.contexts[r.index])

    def close(self) -> None:
        """The window has closed: record the next forward op by op."""
        rec = self.recorder
        rec.capture = rec.captured is None

    def ready(self, follow: set) -> bool:
        """That forward recorded, and every request in ``follow`` done."""
        return (self.recorder.captured is not None
                and follow <= {rs.req.seed
                               for rs in self.engine.results.values()})


def draw(cell, seed: int, seconds: float, device) -> Inputs:
    """The inputs drawn from the seed, in this order: weights, hubs,
    router, the requests' x_T, their contexts and the null context; and
    the followed sample."""
    cfg, traffic = cell.cfg, cell.traffic
    gen = inputs.generator(seed, device)
    params = draw_params(cfg, gen)
    hubs = draw_hubs(cfg, gen)
    router = draw_router(cfg, gen)
    reqs = loadgen.generate(traffic, seed, seconds,
                            TAIL_S if traffic["process"] != "backlog" else 0)
    x_T = inputs.noise(cfg, gen, len(reqs))
    ctx = draw_contexts(cfg, gen, len(reqs))
    return Inputs(gen, params, hubs, router, reqs, x_T, ctx[:-1], ctx[-1:],
                  unet_family.sample_of(cell, reqs, seed))


def build(cell, seed: int, seconds: float, device, clock) -> System:
    """The port, built from the inputs drawn from the seed."""
    return System(cell, draw(cell, seed, seconds, device), clock, device)


def trajectory_gap(cfg: dict, reqs: list, x_T: torch.Tensor, records: dict,
                   answers: dict, scale: float,
                   dtype=torch.float32) -> float:
    """``records[index]``: the (role, t, x, eps) of each row the request
    had in the program's forwards, in order; ``answers[index]``: its
    x0. The reference's sampler is fed each eval's eps (guided: the uncond
    and cond rows combined at ``scale``) and held against every row's
    latent and the answer."""
    gap = 0.0
    with torch.inference_mode():
        for r in reqs:
            s = ref.Sampler(r.sampler, cfg["T"], r.steps,
                            x_T[r.index:r.index + 1], dtype, eta=r.eta,
                            seed=r.index)
            recs = records.get(r.index, [])
            roles = (UNCOND, COND) if scale > 0 else (PLAIN,)
            if len(recs) % len(roles):
                return float("inf")
            for i in range(0, len(recs), len(roles)):
                evl = recs[i:i + len(roles)]
                if s.done or tuple(e[0] for e in evl) != roles or any(
                        int(e[1]) != s.t for e in evl):
                    return float("inf")
                gap = max([gap] + [check.rel(e[2], s.x) for e in evl])
                eps = (ref.guided(evl[0][3], evl[1][3], scale) if scale > 0
                       else evl[0][3])
                s.advance(eps.to(dtype))
            if not s.done or r.index not in answers:
                return float("inf")
            gap = max(gap, check.rel(answers[r.index], s.state))
    return gap


class _Forced(ref.UNet):
    """The reference's forward, each op of ``CAPTURED`` computed from the
    program's recorded input and continued from its recorded output."""

    def __init__(self, cfg, ops, dtype):
        super().__init__(cfg, dtype)
        self.ops = iter(ops)
        self.gap = 0.0

    def _take(self, name, *xs):
        op, xp, yp = next(self.ops)
        if op != name:
            raise StopIteration
        xps = xp if isinstance(xp, tuple) else (xp,)
        for x, p in zip(xs, xps):
            self.gap = max(self.gap, check.rel(x.float(), p))
        return [p.to(self.dtype) for p in xps], yp

    def _check(self, y, yp):
        self.gap = max(self.gap, check.rel(y.float(), yp))
        return yp.to(self.dtype)

    def _product(self, w, x, site, stride=1):
        name = "conv2d_apply" if w[site + "/w"][1].ndim == 4 else \
            "dense_apply"
        (xp,), yp = self._take(name, x)
        return self._check(super()._product(w, xp, site, stride), yp)

    def _gn(self, w, x, site, eps=1e-5):
        (xp,), yp = self._take("groupnorm_apply", x)
        return self._check(super()._gn(w, xp, site, eps), yp)

    def _ln(self, w, x, site):
        (xp,), yp = self._take("layernorm_apply", x)
        return self._check(super()._ln(w, xp, site), yp)

    def _attention(self, q, k, v):
        (qp, kp, vp), yp = self._take("attention", q, k, v)
        return self._check(super()._attention(qp, kp, vp), yp)

    def _geglu(self, h):
        (hp,), yp = self._take("geglu", h)
        return self._check(super()._geglu(hp), yp)


def layer_gap(cfg: dict, weights: ref.Weights, capture: dict,
              contexts: torch.Tensor, null_context: torch.Tensor,
              dtype=torch.float32) -> float:
    """``capture``: ``x``, ``t``, ``eps`` and ``rows`` ((seed, role)) of
    one forward's recorded rows and ``ops``, its calls in order as (name,
    input rows, output rows); ``kv``, every cross-attention k and v
    projection's input over all the forward's rows, whose (seed, role)
    are ``kv_rows``. Each row's context is its own, drawn from the
    seed."""
    gap = context_gap(capture, contexts, null_context)
    with torch.inference_mode(), check.full_f32():
        for r, (seed, role) in enumerate(capture["rows"]):
            t = int(capture["t"][r])
            ctx = null_context if role == UNCOND else contexts[seed:seed + 1]

            def pick(v):
                return (tuple(u[r:r + 1] for u in v) if isinstance(v, tuple)
                        else v[r:r + 1])
            net = _Forced(cfg, [(n, pick(x), pick(y))
                                for n, x, y in capture["ops"]], dtype)
            try:
                out = net(weights.at(t), capture["x"][r:r + 1],
                          capture["t"][r:r + 1], ctx)
            except StopIteration:
                return float("inf")
            if next(net.ops, None) is not None:
                return float("inf")
            gap = max(gap, net.gap, check.rel(out, capture["eps"][r:r + 1]))
    return gap


def context_gap(capture: dict, contexts: torch.Tensor,
                null_context: torch.Tensor) -> float:
    """The largest gap of a row's cross-attention k or v input from the
    context its (seed, role) should get: the null context for an uncond
    row, the request's own otherwise; inf unless there is one such input
    for each attention call of a transformer's cross-attention (one per
    two recorded attention calls, k and v)."""
    kvs = capture["kv"]
    want = torch.cat([null_context if role == UNCOND
                      else contexts[seed:seed + 1]
                      for seed, role in capture["kv_rows"]])
    n_attn = sum(name == "attention" for name, _, _ in capture["ops"])
    if (not kvs or len(kvs) != n_attn
            or any(kv.shape[0] != want.shape[0] for kv in kvs)):
        return float("inf")
    return max(check.rel(kv[i], want[i].to(kv.device)) for kv in kvs
               for i in range(want.shape[0]))


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
    weights = ref.Weights(drawn.params, drawn.hubs, drawn.router, cfg)
    checks = {
        "trajectory_gap": trajectory_gap(
            cfg, [spec[i] for i in system.follow], drawn.x_T, rec.records,
            answers, system.scale),
        "layer_gap": (layer_gap(cfg, weights, rec.captured, drawn.contexts,
                                drawn.null_context)
                      if rec.captured is not None else float("inf"))}
    print(f"reference: {len(system.follow)} trajectories and one forward "
          f"in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return checks
