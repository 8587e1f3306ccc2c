"""The plain reference: the served model worked out again in plain PyTorch.

Written from the published descriptions and the quantizer's definition,
in the order of operations of the port's plain versions, with no kernel,
engine or cache:

* the DDPM/LDM UNet eps-predictor (Ho et al. 2020; Rombach et al. 2022):
  NHWC activations, HWIO conv weights, f32 GroupNorm + SiLU residual
  blocks with a timestep-embedding projection, single-head spatial
  self-attention (f32 products and softmax), 2x nearest upsampling,
  stride-2 downsampling convs, 'SAME' padding;
* W4A4 MSFP: every conv and dense weight snapped to a signed E2M1 grid
  scaled per tensor by its abs-max (``maxval / 6``), every input of a conv
  or dense layer snapped to E2M1 at ``act_maxval`` (nearest, ties to even,
  clipped); each product is the sum over grid values times the weight's
  grid scale, as im2col and one f32 matmul with TF32 off; the io convs
  keep a bfloat16-rounded weight;
* TALoRA (the paper's section 4.2): a router MLP on a sinusoidal timestep
  embedding picks one of ``h`` rank-``r`` adapters per layer (argmax, on
  the host in f32; layers in sorted path order), folded into the weight as
  ``w + A B * alpha / r`` before it is quantized;
* the samplers' step machines: DDIM (Song et al. 2021) at any eta, PLMS
  (Liu et al. 2022) and DPM-Solver-2 (Lu et al. 2022, the midpoint mapped
  to the nearest discrete timestep in log-SNR) at eta 0, per-step
  coefficients as f32 host scalars from a linear beta schedule. DDIM's
  noise at eta > 0 is a standard normal draw a step from a CPU
  ``torch.Generator`` seeded with the request's seed, the seed that the
  benchmark hands the engine with the request.

``UNet`` takes ``dtype``, the type of everything outside the 4-bit
products (norms, attention, the residual stream): float32 as the
configuration states, or bfloat16 for the control.

The UNet, its weights and their merge are the UNet family's reference
(``families/unet.py``). The samplers (``Sampler``, ``n_evals``,
``alpha_bars``, ``timesteps``) are not the UNet's: any diffusion family
reuses them.

Imports torch and numpy only.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

E2M1_MAX = 6.0


# ---------------------------------------------------------------------------
# Architecture: the parameter tree's layout, the order the forward runs.
# ---------------------------------------------------------------------------

def _res_shapes(c_in, c_out, temb_dim):
    p = {"norm1": {"g": (c_in,), "b": (c_in,)},
         "conv1": {"w": (3, 3, c_in, c_out), "b": (c_out,)},
         "temb": {"w": (temb_dim, c_out), "b": (c_out,)},
         "norm2": {"g": (c_out,), "b": (c_out,)},
         "conv2": {"w": (3, 3, c_out, c_out), "b": (c_out,)}}
    if c_in != c_out:
        p["skip"] = {"w": (1, 1, c_in, c_out), "b": (c_out,)}
    return p


def _attn_shapes(c):
    return {"norm": {"g": (c,), "b": (c,)},
            **{k: {"w": (c, c), "b": (c,)} for k in ("q", "k", "v", "proj")}}


def param_shapes(cfg: dict) -> dict:
    """Nested dict of leaf shapes, keyed as the served parameter tree."""
    ch, temb = cfg["ch"], 4 * cfg["ch"]
    p = {"temb0": {"w": (ch, temb), "b": (temb,)},
         "temb1": {"w": (temb, temb), "b": (temb,)},
         "conv_in": {"w": (3, 3, cfg["in_ch"], ch), "b": (ch,)}}
    res, chans, c_cur = cfg["image_size"], [ch], ch
    mults = cfg["ch_mult"]
    for i, mult in enumerate(mults):
        c_out = ch * mult
        for j in range(cfg["num_res_blocks"]):
            p[f"down_{i}.res_{j}"] = _res_shapes(c_cur, c_out, temb)
            c_cur = c_out
            if res in cfg["attn_resolutions"]:
                p[f"down_{i}.attn_{j}"] = _attn_shapes(c_cur)
            chans.append(c_cur)
        if i != len(mults) - 1:
            p[f"down_{i}.downsample"] = {"w": (3, 3, c_cur, c_cur),
                                         "b": (c_cur,)}
            res //= 2
            chans.append(c_cur)
    p["mid.res_0"] = _res_shapes(c_cur, c_cur, temb)
    p["mid.attn"] = _attn_shapes(c_cur)
    p["mid.res_1"] = _res_shapes(c_cur, c_cur, temb)
    for i in reversed(range(len(mults))):
        c_out = ch * mults[i]
        for j in range(cfg["num_res_blocks"] + 1):
            p[f"up_{i}.res_{j}"] = _res_shapes(c_cur + chans.pop(), c_out,
                                               temb)
            c_cur = c_out
            if res in cfg["attn_resolutions"]:
                p[f"up_{i}.attn_{j}"] = _attn_shapes(c_cur)
        if i != 0:
            p[f"up_{i}.upsample"] = {"w": (3, 3, c_cur, c_cur),
                                     "b": (c_cur,)}
            res *= 2
    p["norm_out"] = {"g": (c_cur,), "b": (c_cur,)}
    p["conv_out"] = {"w": (3, 3, c_cur, cfg["out_ch"]), "b": (cfg["out_ch"],)}
    return p


def flat_shapes(cfg: dict) -> dict[str, tuple]:
    """'/'-joined leaf path -> shape, in the tree's order."""
    out = {}
    for mod, leaves in param_shapes(cfg).items():
        for sub, v in leaves.items():
            if isinstance(v, dict):
                for leaf, shape in v.items():
                    out[f"{mod}/{sub}/{leaf}"] = shape
            else:
                out[f"{mod}/{sub}"] = v
    return out


IO_SITES = ("conv_in", "conv_out")


def weight_sites(cfg: dict) -> list[str]:
    """Every conv and dense weight path (the quantized and adapted ones)."""
    return [k for k, s in flat_shapes(cfg).items()
            if k.endswith("/w") and len(s) >= 2]


def flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# Quantization.
# ---------------------------------------------------------------------------

def e2m1_snap(y: torch.Tensor) -> torch.Tensor:
    """Nearest E2M1 grid point of |y| >= 0 (ties to even), clipped at 6:
    steps of 1/2 below 2, 1 in [2, 4), 2 from 4."""
    _, e = torch.frexp(y)
    octave = (e - 1).clamp(0, 2)
    step = torch.ldexp(torch.ones_like(y), octave - 1)
    q = torch.round(y / step) * step
    return torch.where(q > E2M1_MAX, torch.full_like(q, E2M1_MAX), q)


def snap_act(x: torch.Tensor, maxval: float) -> torch.Tensor:
    """Signed E2M1 fake-quant of an activation at ``maxval``, in f32:
    ``sign(x) * snap(|x| / s) * s`` with ``s = maxval * (1/6)`` and the
    division taken as a multiply by ``1 / s``."""
    x = x.float()
    s = torch.tensor(maxval, dtype=torch.float32, device=x.device) * (
        1.0 / E2M1_MAX)
    inv = 1.0 / torch.clamp_min(s, 1e-30)
    return torch.sign(x) * (e2m1_snap(torch.abs(x) * inv) * s)


def quantize_weight(w: torch.Tensor, maxval: torch.Tensor):
    """(grid values, grid scale) of ``w`` on the signed E2M1 grid topped at
    ``maxval``: ``|w|`` times ``1 / (maxval / 6)`` snapped, signed; the
    served weight is values x ``maxval * (1/6)``."""
    s_enc = maxval / torch.tensor(E2M1_MAX, device=w.device)
    inv = 1.0 / torch.clamp_min(s_enc, 1e-30)
    g = e2m1_snap(torch.abs(w) * inv)
    return torch.where(w < 0, -g, g), maxval * (1.0 / E2M1_MAX)


# ---------------------------------------------------------------------------
# TALoRA routing and merge.
# ---------------------------------------------------------------------------

def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """DDPM timestep embedding, cos then sin, f32."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(10_000.0) * ar / half)
    args = t.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def route_slots(router: dict, T: int, n_layers: int, talora: dict
                ) -> np.ndarray:
    """(T, n_layers) argmax slot per timestep and layer, f32 on the host."""
    r = {k: v.detach().to("cpu", torch.float32) for k, v in router.items()}
    emb = sinusoid(torch.arange(T, dtype=torch.float32), talora["t_emb_dim"])
    hid = torch.tanh(emb @ r["w1"] + r["b1"])
    out = hid @ r["w2"] + r["b2"]
    logits = out.reshape(T, n_layers, talora["hub_size"])
    return torch.argmax(logits, dim=-1).numpy()


class Weights:
    """Served weights per timestep from the base weights, adapters and
    router handed to the program, worked out again for each routing."""

    def __init__(self, params: dict, hubs: dict, router: dict, cfg: dict):
        self.cfg = cfg
        self.flat = flatten(params)
        self.hubs = hubs
        self.names = sorted(hubs)
        tal = cfg["talora"]
        self.h = tal["hub_size"]
        self.lora_scale = tal["alpha"] / tal["rank"]
        self.slots = route_slots(router, cfg["T"], len(self.names), tal)
        self.maxval = {k: torch.clamp_min(
            torch.max(torch.abs(self.flat[k])).to(torch.float32), 1e-8)
            for k in weight_sites(cfg)}

    def n_segments(self) -> int:
        s = self.slots
        return 1 + int(np.sum(np.any(s[1:] != s[:-1], axis=1)))

    def at(self, t: int) -> dict:
        """site/w -> ('q', grid values, grid scale) or ('io', weight); the
        other leaves as given."""
        out = dict(self.flat)
        for i, site in enumerate(self.names):
            w = self.flat[site]
            hub = self.hubs[site]
            sel = F.one_hot(torch.tensor(int(self.slots[t, i])), self.h).to(
                w.device, torch.float32)
            a_sel = torch.einsum("h,hir->ir", sel, hub["A"])
            b_sel = torch.einsum("h,hro->ro", sel, hub["B"])
            delta = (a_sel @ b_sel).reshape(w.shape) * self.lora_scale
            merged = w + delta.to(w.dtype)
            if site.rsplit("/", 1)[0] in IO_SITES:
                out[site] = ("io", merged.to(torch.bfloat16).float())
            else:
                out[site] = ("q", *quantize_weight(merged, self.maxval[site]))
        return out


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    b, h, w, c = x.shape
    (p0, p1), (q0, q1) = _same_pads(h, k, stride), _same_pads(w, k, stride)
    oh, ow = -(-h // stride), -(-w // stride)
    xp = F.pad(x, (0, 0, q0, q1, p0, p1))
    cols = [xp[:, i:i + stride * (oh - 1) + 1:stride,
               j:j + stride * (ow - 1) + 1:stride, :]
            for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1) if len(cols) > 1 else cols[0]


class UNet:
    """The eps-predictor over one timestep's weights (``Weights.at``)."""

    def __init__(self, cfg: dict, dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.act_maxval = cfg["act_maxval"]
        self.groups = cfg["gn_groups"]

    def _product(self, w, x, site, stride=1):
        """Snapped ``x`` times the site's weight (a conv if 4-D), + bias."""
        kind, wt = w[site + "/w"][0], w[site + "/w"][1]
        bias = w[site + "/b"]
        xs = snap_act(x, self.act_maxval)
        if wt.ndim == 4:
            cols = _im2col(xs, wt.shape[0], stride)
            y = cols.reshape(-1, cols.shape[-1]) @ wt.reshape(-1, wt.shape[-1])
            y = y.reshape(*cols.shape[:3], wt.shape[-1])
        else:
            y = (xs.reshape(-1, xs.shape[-1]) @ wt).reshape(
                *xs.shape[:-1], wt.shape[-1])
        if kind == "q":
            y = y * w[site + "/w"][2]
        return (y + bias).to(self.dtype)

    def _gn(self, w, x, site):
        b, h, wd, c = x.shape
        g = min(self.groups, c)
        xf = x.to(self.dtype).reshape(b, h, wd, g, c // g)
        mu = xf.mean(dim=(1, 2, 4), keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
        n = ((xf - mu) * torch.rsqrt(var + 1e-5)).reshape(b, h, wd, c)
        return n * w[site + "/g"].to(self.dtype) + w[site + "/b"].to(
            self.dtype)

    @staticmethod
    def _silu(x):
        return x * torch.sigmoid(x)

    def _res(self, w, x, temb, site):
        h = self._silu(self._gn(w, x, f"{site}/norm1"))
        h = self._product(w, h, f"{site}/conv1")
        h = h + self._product(w, self._silu(temb),
                              f"{site}/temb")[:, None, None, :]
        h = self._silu(self._gn(w, h, f"{site}/norm2"))
        h = self._product(w, h, f"{site}/conv2")
        if f"{site}/skip/w" in w:
            x = self._product(w, x, f"{site}/skip")
        return x + h

    def _attn(self, w, x, site):
        b, hh, ww, c = x.shape
        h = self._gn(w, x, f"{site}/norm").reshape(b, hh * ww, c)
        q, k, v = (self._product(w, h, f"{site}/{n}") for n in "qkv")
        s = torch.einsum("bqc,bkc->bqk", q, k)
        p = torch.softmax(s * (c ** -0.5), dim=-1)
        o = self._product(w, torch.einsum("bqk,bkc->bqc", p, v),
                          f"{site}/proj")
        return x + o.reshape(b, hh, ww, c)

    def __call__(self, w: dict, x: torch.Tensor, t: torch.Tensor
                 ) -> torch.Tensor:
        """x (B, H, W, C), t (B,) -> eps (B, H, W, C) in f32."""
        cfg = self.cfg
        x = x.to(self.dtype)
        temb = self._product(w, sinusoid(t, cfg["ch"]), "temb0")
        temb = self._product(w, self._silu(temb), "temb1")
        h = self._product(w, x, "conv_in")
        hs = [h]
        mults = cfg["ch_mult"]
        for i in range(len(mults)):
            for j in range(cfg["num_res_blocks"]):
                h = self._res(w, h, temb, f"down_{i}.res_{j}")
                if f"down_{i}.attn_{j}/q/w" in w:
                    h = self._attn(w, h, f"down_{i}.attn_{j}")
                hs.append(h)
            if i != len(mults) - 1:
                h = self._product(w, h, f"down_{i}.downsample", stride=2)
                hs.append(h)
        h = self._res(w, h, temb, "mid.res_0")
        h = self._attn(w, h, "mid.attn")
        h = self._res(w, h, temb, "mid.res_1")
        for i in reversed(range(len(mults))):
            for j in range(cfg["num_res_blocks"] + 1):
                h = self._res(w, torch.cat([h, hs.pop()], dim=-1), temb,
                              f"up_{i}.res_{j}")
                if f"up_{i}.attn_{j}/q/w" in w:
                    h = self._attn(w, h, f"up_{i}.attn_{j}")
            if i != 0:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = self._product(w, h, f"up_{i}.upsample")
        h = self._silu(self._gn(w, h, "norm_out"))
        return self._product(w, h, "conv_out").float()


# ---------------------------------------------------------------------------
# Schedule and samplers: one request's step machine.
# ---------------------------------------------------------------------------

def alpha_bars(T: int) -> torch.Tensor:
    """Cumulative products of 1 - beta, linear betas in [1e-4, 0.02],
    computed in float64 and stored as f32 on the host."""
    betas = np.linspace(1e-4, 0.02, T, dtype=np.float64)
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32)


def timesteps(T: int, steps: int) -> list[int]:
    """Uniform-stride subsequence of [0, T), descending."""
    seq = np.unique(np.linspace(0, T - 1, steps).round().astype(np.int64))
    return [int(t) for t in seq[::-1]]


def n_evals(sampler: str, T: int, steps: int) -> int:
    n = len(timesteps(T, steps))
    return 2 * (n - 1) + 1 if sampler == "dpm_solver2" else n


def _ddim(ab, x, t, t_prev, eps, eta=0.0, noise=None):
    """x_t -> x_{t_prev} (t_prev = -1: x0); ``noise`` at eta > 0."""
    a_t = ab[t]
    a_p = ab[t_prev] if t_prev >= 0 else torch.tensor(1.0)
    x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    sigma = eta * torch.sqrt((1 - a_p) / (1 - a_t)) * torch.sqrt(
        1 - a_t / a_p)
    dir_xt = torch.sqrt(torch.clamp_min(1 - a_p - sigma ** 2, 0.0)) * eps
    out = torch.sqrt(a_p) * x0 + dir_xt
    if noise is not None:
        out = out + sigma * noise
    return out


class Sampler:
    """A request's trajectory, one eps at a time: ``t`` names the timestep
    to evaluate next and ``x`` the latent to evaluate, ``advance(eps)``
    consumes it; the latents in ``dtype`` (float32, or bfloat16 for the
    control). DDIM runs at ``eta``, its noise drawn from ``seed``."""

    def __init__(self, kind: str, T: int, steps: int, x_T: torch.Tensor,
                 dtype=torch.float32, eta: float = 0.0, seed: int = 0):
        if kind not in ("ddim", "plms", "dpm_solver2"):
            raise ValueError(f"unknown sampler {kind!r}")
        self.kind = kind
        self.eta = float(eta) if kind == "ddim" else 0.0
        self.gen = torch.Generator().manual_seed(seed)
        self.ab = alpha_bars(T)
        self.seq = timesteps(T, steps)
        self.state = x_T.to(dtype)
        self.i = 0
        self.done = False
        self.old: list = []
        self.mid = False
        if kind == "dpm_solver2":
            self.lams = 0.5 * torch.log(self.ab / (1 - self.ab))
            self.final = len(self.seq) == 1

    @property
    def t(self) -> int:
        if self.kind == "dpm_solver2":
            if self.mid:
                return self.t_mid
            if self.final:
                return self.seq[-1]
        return self.seq[self.i]

    @property
    def x(self) -> torch.Tensor:
        return self.u if self.kind == "dpm_solver2" and self.mid else \
            self.state

    def advance(self, eps: torch.Tensor) -> None:
        ab, seq, i = self.ab, self.seq, self.i
        if self.kind == "dpm_solver2":
            self._dpm(eps)
            return
        t, t_prev = seq[i], (seq[i + 1] if i + 1 < len(seq) else -1)
        if self.kind == "plms":
            old = self.old
            if len(old) == 0:
                e = eps
            elif len(old) == 1:
                e = (3 * eps - old[-1]) / 2
            elif len(old) == 2:
                e = (23 * eps - 16 * old[-1] + 5 * old[-2]) / 12
            else:
                e = (55 * eps - 59 * old[-1] + 37 * old[-2]
                     - 9 * old[-3]) / 24
            self.old = (old + [eps])[-3:]
            eps = e
        noise = None
        if self.eta > 0:
            noise = torch.randn(self.state.shape, generator=self.gen).to(
                self.state.device, self.state.dtype)
        self.state = _ddim(ab, self.state, t, t_prev, eps, self.eta, noise)
        self.i += 1
        self.done = self.i >= len(seq)

    def _dpm(self, eps):
        ab, seq = self.ab, self.seq
        if self.final:
            self.state = _ddim(ab, self.state, seq[-1], -1, eps)
            self.done = True
            return
        t, t_next = seq[self.i], seq[self.i + 1]
        a_t = torch.sqrt(ab[t])
        if not self.mid:
            l_t, l_n = self.lams[t], self.lams[t_next]
            h = l_n - l_t
            self.t_mid = int(torch.argmin(torch.abs(self.lams
                                                    - (l_t + 0.5 * h))))
            a_m, s_m = torch.sqrt(ab[self.t_mid]), torch.sqrt(
                1 - ab[self.t_mid])
            self.u = (a_m / a_t) * self.state - s_m * torch.expm1(
                0.5 * h) * eps
            self.h = h
            self.mid = True
            return
        a_n, s_n = torch.sqrt(ab[t_next]), torch.sqrt(1 - ab[t_next])
        self.state = (a_n / a_t) * self.state - s_n * torch.expm1(
            self.h) * eps
        self.u = None
        self.i += 1
        self.mid = False
        self.final = self.i >= len(seq) - 1
