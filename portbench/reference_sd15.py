"""The plain reference of the ``sd15`` family: Stable Diffusion v1.5's
text-to-image UNet eps-predictor, its W4A4 MSFP weights and its guided
DDIM sampler, worked out again in plain PyTorch.

Written from the published model: the UNet of CompVis/stable-diffusion
(``ldm/modules/diffusionmodules/openaimodel.py``) as
``configs/stable-diffusion/v1-inference.yaml`` and the Hugging Face
``unet/config.json`` configure it, and its spatial transformer from
``ldm/modules/attention.py``:

* the UNet: NHWC activations, HWIO conv weights, the residual blocks,
  downsampling and upsampling of ``reference.UNet`` (the same
  eps-predictor skeleton; ``flip_sin_to_cos`` timestep embedding);
* after each residual block of the attention levels and in the middle
  block, a spatial transformer of depth 1: GroupNorm (32 groups, eps
  1e-6), a 1x1 ``proj_in``, then ``x + attn1(norm1(x))`` (self-attention),
  ``x + attn2(norm2(x), context)`` (cross-attention to the row's text
  context), ``x + ff(norm3(x))`` (GEGLU of inner width 4c, exact erf
  GELU), LayerNorms at eps 1e-5, a 1x1 ``proj_out`` and the block's
  residual; attention of ``num_heads`` heads, ``softmax(q k^T * d^-0.5)
  v`` per head, q/k/v without bias, the output projection with one;
* W4A4 MSFP and the TALoRA merge of ``reference.Weights`` (E2M1
  weights by per-tensor abs-max, E2M1 acts at ``act_maxval`` on every
  conv and dense input, the io convs in bfloat16), reused by import;
* classifier-free guidance, ``eps_u + s * (eps_c - eps_u)``, with the
  uncond row on the null prompt's context;
* DDIM over the ``scaled_linear`` schedule (betas from 0.00085 to 0.012,
  quadratic in their square roots) at the configuration's ``T``, the
  step machine of ``reference.Sampler`` on this schedule.

``UNet`` takes ``dtype``, the type of everything outside the 4-bit
products (norms, attention, GEGLU, the residual stream): float32 as the
configuration states, or bfloat16 for the control. Its forward runs with
TF32 off for matmuls and cuDNN (``no_tf32``).

Departures from the published model (each also one of the port's):

* ``T`` is 100, not 1000, and DDIM's timesteps are the uniform
  ``reference.timesteps`` over [0, T) (txt2img's are ``range(0, 1000,
  1000 // steps) + 1``);
* the stride-2 downsampling convs pad 'SAME' (none before, one after), as
  every UNet of the port does, where the published pads one on each side;
* weights are random (``families/sd15.py`` draws them from the seed at
  fan-in scale, ``proj_out`` and the residual blocks' second conv
  included, which the published initialises at zero);
* the CLIP text encoder and the VAE decoder are not run: a row's
  (77, 768) context is drawn from the seed, standing in for a prompt's
  encoding, and the cell serves the UNet's sampling of the latents.

Imports torch, numpy and ``portbench.reference`` only.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench import reference


# ---------------------------------------------------------------------------
# Architecture: the parameter tree's layout, in the order the forward runs.
# ---------------------------------------------------------------------------

def _transformer_shapes(c: int, c_ctx: int) -> dict:
    def mha(c_kv):
        return {"q/w": (c, c), "k/w": (c_kv, c), "v/w": (c_kv, c),
                "out/w": (c, c), "out/b": (c,)}
    p = {"norm/g": (c,), "norm/b": (c,),
         "proj_in/w": (1, 1, c, c), "proj_in/b": (c,),
         "norm1/g": (c,), "norm1/b": (c,)}
    p.update({f"attn1/{k}": s for k, s in mha(c).items()})
    p.update({"norm2/g": (c,), "norm2/b": (c,)})
    p.update({f"attn2/{k}": s for k, s in mha(c_ctx).items()})
    p.update({"norm3/g": (c,), "norm3/b": (c,),
              "ff/proj/w": (c, 8 * c), "ff/proj/b": (8 * c,),
              "ff/out/w": (4 * c, c), "ff/out/b": (c,),
              "proj_out/w": (1, 1, c, c), "proj_out/b": (c,)})
    return p


def flat_shapes(cfg: dict) -> dict[str, tuple]:
    """'/'-joined leaf path -> shape, keyed as the served parameter tree."""
    ch, temb = cfg["ch"], 4 * cfg["ch"]
    out: dict[str, tuple] = {}

    def add(mod, leaves):
        for sub, v in leaves.items():
            if isinstance(v, dict):
                for leaf, shape in v.items():
                    out[f"{mod}/{sub}/{leaf}"] = shape
            else:
                out[f"{mod}/{sub}"] = v

    def transformer(mod, c):
        out.update({f"{mod}/{k}": s for k, s in
                    _transformer_shapes(c, cfg["context_dim"]).items()})

    add("temb0", {"w": (ch, temb), "b": (temb,)})
    add("temb1", {"w": (temb, temb), "b": (temb,)})
    add("conv_in", {"w": (3, 3, cfg["in_ch"], ch), "b": (ch,)})
    res, chans, c_cur = cfg["image_size"], [ch], ch
    mults = cfg["ch_mult"]
    for i, mult in enumerate(mults):
        c_out = ch * mult
        for j in range(cfg["num_res_blocks"]):
            add(f"down_{i}.res_{j}", reference._res_shapes(c_cur, c_out,
                                                           temb))
            c_cur = c_out
            if res in cfg["attn_resolutions"]:
                transformer(f"down_{i}.attn_{j}", c_cur)
            chans.append(c_cur)
        if i != len(mults) - 1:
            add(f"down_{i}.downsample", {"w": (3, 3, c_cur, c_cur),
                                         "b": (c_cur,)})
            res //= 2
            chans.append(c_cur)
    add("mid.res_0", reference._res_shapes(c_cur, c_cur, temb))
    transformer("mid.attn", c_cur)
    add("mid.res_1", reference._res_shapes(c_cur, c_cur, temb))
    for i in reversed(range(len(mults))):
        c_out = ch * mults[i]
        for j in range(cfg["num_res_blocks"] + 1):
            add(f"up_{i}.res_{j}", reference._res_shapes(
                c_cur + chans.pop(), c_out, temb))
            c_cur = c_out
            if res in cfg["attn_resolutions"]:
                transformer(f"up_{i}.attn_{j}", c_cur)
        if i != 0:
            add(f"up_{i}.upsample", {"w": (3, 3, c_cur, c_cur),
                                     "b": (c_cur,)})
            res *= 2
    add("norm_out", {"g": (c_cur,), "b": (c_cur,)})
    add("conv_out", {"w": (3, 3, c_cur, cfg["out_ch"]),
                     "b": (cfg["out_ch"],)})
    return out


def weight_sites(cfg: dict) -> list[str]:
    """Every conv and dense weight path (the quantized and adapted ones)."""
    return [k for k, s in flat_shapes(cfg).items()
            if k.endswith("/w") and len(s) >= 2]


def n_params(cfg: dict) -> int:
    return int(sum(np.prod(s) for s in flat_shapes(cfg).values()))


class Weights(reference.Weights):
    """``reference.Weights`` (the TALoRA merge and FP4 grid per timestep)
    over this UNet's weight sites."""

    def __init__(self, params: dict, hubs: dict, router: dict, cfg: dict):
        self.cfg = cfg
        self.flat = reference.flatten(params)
        self.hubs = hubs
        self.names = sorted(hubs)
        tal = cfg["talora"]
        self.h = tal["hub_size"]
        self.lora_scale = tal["alpha"] / tal["rank"]
        self.slots = reference.route_slots(router, cfg["T"], len(self.names),
                                           tal)
        self.maxval = {k: torch.clamp_min(
            torch.max(torch.abs(self.flat[k])).to(torch.float32), 1e-8)
            for k in weight_sites(cfg)}


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_tf32():
    """f32 products in f32 on the card: TF32 off for matmuls and cuDNN."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


class UNet(reference.UNet):
    """The eps-predictor over one timestep's weights (``Weights.at``) and
    each row's text context."""

    def __init__(self, cfg: dict, dtype=torch.float32):
        super().__init__(cfg, dtype)
        self.heads = cfg["num_heads"]

    def _product(self, w, x, site, stride=1):
        """Snapped ``x`` times the site's weight (a conv if 4-D), + its
        bias where it has one."""
        kind, wt = w[site + "/w"][0], w[site + "/w"][1]
        xs = reference.snap_act(x, self.act_maxval)
        if wt.ndim == 4:
            cols = reference._im2col(xs, wt.shape[0], stride)
            y = cols.reshape(-1, cols.shape[-1]) @ wt.reshape(-1, wt.shape[-1])
            y = y.reshape(*cols.shape[:3], wt.shape[-1])
        else:
            y = (xs.reshape(-1, xs.shape[-1]) @ wt).reshape(
                *xs.shape[:-1], wt.shape[-1])
        if kind == "q":
            y = y * w[site + "/w"][2]
        if site + "/b" in w:
            y = y + w[site + "/b"]
        return y.to(self.dtype)

    def _gn(self, w, x, site, eps=1e-5):
        b, h, wd, c = x.shape
        g = min(self.groups, c)
        xf = x.to(self.dtype).reshape(b, h, wd, g, c // g)
        mu = xf.mean(dim=(1, 2, 4), keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=(1, 2, 4), keepdim=True)
        n = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, h, wd, c)
        return n * w[site + "/g"].to(self.dtype) + w[site + "/b"].to(
            self.dtype)

    def _ln(self, w, x, site):
        xf = x.to(self.dtype)
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        n = (xf - mu) * torch.rsqrt(var + 1e-5)
        return n * w[site + "/g"].to(self.dtype) + w[site + "/b"].to(
            self.dtype)

    def _attention(self, q, k, v):
        """Per head: ``softmax(q k^T * d^-0.5) v``."""
        b, n, c = q.shape
        d = c // self.heads

        def split(t):
            return t.to(self.dtype).reshape(b, -1, self.heads, d)
        s = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k)) * d ** -0.5
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, split(v)).reshape(b, n, c)

    def _geglu(self, h):
        a, gate = h.to(self.dtype).chunk(2, dim=-1)
        return a * F.gelu(gate)

    def _mha(self, w, x, kv, site):
        q = self._product(w, x, f"{site}/q")
        k = self._product(w, kv, f"{site}/k")
        v = self._product(w, kv, f"{site}/v")
        return self._product(w, self._attention(q, k, v), f"{site}/out")

    def _transformer(self, w, x, context, site):
        b, hh, ww, c = x.shape
        h = self._gn(w, x, f"{site}/norm", eps=1e-6)
        h = self._product(w, h, f"{site}/proj_in").reshape(b, hh * ww, c)
        n = self._ln(w, h, f"{site}/norm1")
        h = h + self._mha(w, n, n, f"{site}/attn1")
        h = h + self._mha(w, self._ln(w, h, f"{site}/norm2"), context,
                          f"{site}/attn2")
        f = self._product(w, self._ln(w, h, f"{site}/norm3"),
                          f"{site}/ff/proj")
        h = h + self._product(w, self._geglu(f), f"{site}/ff/out")
        h = self._product(w, h.reshape(b, hh, ww, c), f"{site}/proj_out")
        return x + h

    def __call__(self, w: dict, x: torch.Tensor, t: torch.Tensor,
                 context: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C), t (B,), context (B, L, D) -> eps (B, H, W, C)
        in f32."""
        with no_tf32():
            return self._forward(w, x, t, context)

    def _forward(self, w, x, t, context):
        cfg = self.cfg
        x = x.to(self.dtype)
        context = context.to(self.dtype)
        temb = self._product(w, reference.sinusoid(t, cfg["ch"]), "temb0")
        temb = self._product(w, self._silu(temb), "temb1")
        h = self._product(w, x, "conv_in")
        hs = [h]
        mults = cfg["ch_mult"]
        for i in range(len(mults)):
            for j in range(cfg["num_res_blocks"]):
                h = self._res(w, h, temb, f"down_{i}.res_{j}")
                if f"down_{i}.attn_{j}/attn1/q/w" in w:
                    h = self._transformer(w, h, context, f"down_{i}.attn_{j}")
                hs.append(h)
            if i != len(mults) - 1:
                h = self._product(w, h, f"down_{i}.downsample", stride=2)
                hs.append(h)
        h = self._res(w, h, temb, "mid.res_0")
        h = self._transformer(w, h, context, "mid.attn")
        h = self._res(w, h, temb, "mid.res_1")
        for i in reversed(range(len(mults))):
            for j in range(cfg["num_res_blocks"] + 1):
                h = self._res(w, torch.cat([h, hs.pop()], dim=-1), temb,
                              f"up_{i}.res_{j}")
                if f"up_{i}.attn_{j}/attn1/q/w" in w:
                    h = self._transformer(w, h, context, f"up_{i}.attn_{j}")
            if i != 0:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = self._product(w, h, f"up_{i}.upsample")
        h = self._silu(self._gn(w, h, "norm_out"))
        return self._product(w, h, "conv_out").float()


# ---------------------------------------------------------------------------
# Guidance, schedule and sampler.
# ---------------------------------------------------------------------------

def guided(eps_u: torch.Tensor, eps_c: torch.Tensor, scale: float
           ) -> torch.Tensor:
    """Classifier-free guidance: ``eps_u + s * (eps_c - eps_u)``."""
    return eps_u + scale * (eps_c - eps_u)


def alpha_bars(T: int) -> torch.Tensor:
    """Cumulative products of 1 - beta over the ``scaled_linear`` betas
    (``linspace(0.00085 ** 0.5, 0.012 ** 0.5, T) ** 2``), computed in
    float64 and stored as f32 on the host."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T,
                        dtype=np.float64) ** 2
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32)


class Sampler(reference.Sampler):
    """``reference.Sampler``'s step machine on the ``scaled_linear``
    schedule."""

    def __init__(self, kind: str, T: int, steps: int, x_T: torch.Tensor,
                 dtype=torch.float32, eta: float = 0.0, seed: int = 0):
        super().__init__(kind, T, steps, x_T, dtype, eta, seed)
        self.ab = alpha_bars(T)
        if kind == "dpm_solver2":
            self.lams = 0.5 * torch.log(self.ab / (1 - self.ab))
