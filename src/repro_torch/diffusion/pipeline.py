"""Diffusion quantization pipeline: calibrate -> plan -> finetune -> sample;
port of ``repro.diffusion.pipeline``.

Glue between the paper's stages:
  1. a Q-Diffusion-style calibration set: intermediate x_t states collected
     along FP-teacher DDIM trajectories (uniform over timesteps);
  2. per-site activations recorded through the FP model, AAL/NAL
     classified, the MSFP search run (``core.msfp``);
  3. the weights fake-quantized, TALoRA attached, fine-tuned
     (``train.finetune``);
  4. sampling with the quantized, TALoRA-merged model.

Everything runs on the device the FP params live on (the card, unless
the caller built them on the CPU). Random draws (the calibration x_T, the
hubs and router) come from a CPU ``torch.Generator`` seeded with ``seed``;
the reference draws them from ``jax.random``, which torch cannot
reproduce, so parity tests inject the reference's x_T (``x_T``) and its
hubs and router (``convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.common.tree import flatten_paths, tree_map, unflatten_paths
from repro_torch.core import msfp, talora
from repro_torch.diffusion.samplers import ddim_sample
from repro_torch.diffusion.schedule import NoiseSchedule
from repro_torch.nn.unet import UNetConfig, io_sites, unet_apply
from repro_torch.quant.calibrate import CalibrationDB, QuantContext


def params_device(params: dict) -> torch.device:
    return next(iter(flatten_paths(params).values())).device


@dataclasses.dataclass
class QuantizedDiffusion:
    """Everything needed to run / fine-tune the quantized model."""
    cfg: UNetConfig
    sched: NoiseSchedule
    fp_params: dict
    q_params: dict              # weights fake-quantized under `plan`
    plan: msfp.QuantPlan
    talora_cfg: talora.TALoRAConfig | None = None
    hubs: dict | None = None
    router: dict | None = None

    def to(self, device) -> "QuantizedDiffusion":
        """The bundle with every tree and the plan on ``device``."""
        def move(tree):
            return None if tree is None else tree_map(
                lambda v: v.to(device), tree)
        return dataclasses.replace(
            self, fp_params=move(self.fp_params),
            q_params=move(self.q_params), plan=self.plan.to(device),
            hubs=move(self.hubs), router=move(self.router))

    def teacher_eps(self, x, t, y=None):
        return unet_apply(self.fp_params, x, t, self.cfg, y=y)

    def student_eps(self, x, t, y=None, hubs=None, router=None):
        """Quantized forward; TALoRA merged per distinct batch timestep.

        The router selects adapters per timestep, so a batch that mixes
        timesteps is routed per t group (merge + forward per group,
        scattered back in order).
        """
        hubs = hubs if hubs is not None else self.hubs
        router = router if router is not None else self.router
        ctx = QuantContext("quantize", plan=self.plan,
                           act_fn=msfp.quantize_act)
        if hubs is None or router is None:
            return unet_apply(self.q_params, x, t, self.cfg, y=y, ctx=ctx)

        names = sorted(hubs)
        t_flat = torch.as_tensor(t).reshape(-1)

        def merged_for(t_scalar):
            sels = talora.route(router, t_scalar, names, self.talora_cfg)
            return talora.merge_into_tree(self.q_params, hubs, sels,
                                          self.talora_cfg)

        t_vals = t_flat.detach().cpu().numpy()
        uniq = np.unique(t_vals)
        if uniq.size <= 1:
            return unet_apply(merged_for(t_flat[0]), x, t, self.cfg, y=y,
                              ctx=ctx)
        out = None
        for tv in uniq:
            idx = torch.from_numpy(np.nonzero(t_vals == tv)[0]).to(x.device)
            eps = unet_apply(merged_for(torch.tensor(tv, dtype=torch.float32,
                                                     device=x.device)),
                             x[idx], t_flat[idx], self.cfg,
                             y=None if y is None else y[idx], ctx=ctx)
            if out is None:
                out = eps.new_zeros((x.shape[0],) + tuple(eps.shape[1:]))
            out = out.index_copy(0, idx, eps)
        return out


@torch.no_grad()
def build_calibration_set(fp_params, cfg: UNetConfig, sched: NoiseSchedule, *,
                          seed: int = 0, n_samples: int = 32, steps: int = 20,
                          batch: int = 8, x_T: list | None = None
                          ) -> list[tuple[int, torch.Tensor]]:
    """Q-Diffusion calibration: (t, x_t) states from FP DDIM trajectories,
    ``n_samples // batch`` trajectories of ``batch`` (``x_T``: each
    trajectory's start, else drawn from a generator seeded ``seed``)."""
    dev = params_device(fp_params)
    gen = torch.Generator().manual_seed(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.in_ch)
    taps: list[tuple[int, torch.Tensor]] = []
    for b in range(max(1, n_samples // batch)):
        x0 = (torch.randn(shape, generator=gen) if x_T is None
              else torch.as_tensor(x_T[b]))
        _, tp = ddim_sample(lambda x, t: unet_apply(fp_params, x, t, cfg),
                            sched, shape, steps=steps, collect_every=1,
                            x_T=x0, device=dev)
        taps.extend(tp)
    return taps


@torch.no_grad()
def calibrate_activations(fp_params, cfg: UNetConfig, calib: list,
                          max_batches: int = 8) -> CalibrationDB:
    """Record every quant site's input over the first ``max_batches``
    calibration states (``calib``: (t, x_t) pairs, tensors or numpy)."""
    dev = params_device(fp_params)
    db = CalibrationDB()
    ctx = QuantContext("collect", db=db)
    for t, x in calib[:max_batches]:
        x = torch.as_tensor(x).to(dev, torch.float32)
        tb = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                        device=dev)
        unet_apply(fp_params, x, tb, cfg, ctx=ctx)
    return db


def quantize_diffusion(fp_params, cfg: UNetConfig, sched: NoiseSchedule, *,
                       seed: int = 0, bits_w: int = 4, bits_a: int = 4,
                       mode: str = "msfp", calib: list | None = None,
                       talora_cfg: talora.TALoRAConfig | None = None,
                       progress: Callable[[str], None] | None = None
                       ) -> QuantizedDiffusion:
    """Stages 1-3 (without the fine-tune loop): returns a ready bundle."""
    dev = params_device(fp_params)
    if calib is None:
        calib = build_calibration_set(fp_params, cfg, sched, seed=seed)
    db = calibrate_activations(fp_params, cfg, calib)
    weights = {k: v for k, v in flatten_paths(fp_params).items()
               if k.endswith("/w")}
    plan = msfp.build_mixed_plan(weights, db, bits_w=bits_w, bits_a=bits_a,
                                 mode=mode, io_sites=io_sites(fp_params),
                                 device=dev, progress=progress)
    qw = msfp.quantize_weight_tree(weights, plan)
    flat = dict(flatten_paths(fp_params))
    flat.update(qw)
    bundle = QuantizedDiffusion(cfg, sched, fp_params, unflatten_paths(flat),
                                plan)
    if talora_cfg is not None:
        attach_talora(bundle, talora_cfg, seed=seed)
    return bundle


def attach_talora(bundle: QuantizedDiffusion, talora_cfg: talora.TALoRAConfig,
                  *, seed: int = 0) -> QuantizedDiffusion:
    """A TALoRA hub on every (fake-quantized) weight of the tree, and the
    router (A ~ N(0, 1/r), B = 0)."""
    dims = talora.lora_target_dims_from_weights(
        {k: v for k, v in flatten_paths(bundle.q_params).items()
         if k.endswith("/w") and v.ndim >= 2})
    gen = torch.Generator().manual_seed(seed)
    dev = params_device(bundle.q_params)
    bundle.talora_cfg = talora_cfg
    bundle.hubs = talora.init_lora_hub(gen, dims, talora_cfg, dev)
    bundle.router = talora.init_router(gen, len(dims), talora_cfg, dev)
    return bundle


@torch.no_grad()
def sample_quantized(bundle: QuantizedDiffusion, *, seed: int = 0, n: int = 8,
                     steps: int = 20, eta: float = 0.0,
                     x_T: torch.Tensor | None = None) -> torch.Tensor:
    cfg = bundle.cfg
    x0, _ = ddim_sample(lambda x, t: bundle.student_eps(x, t), bundle.sched,
                        (n, cfg.image_size, cfg.image_size, cfg.in_ch),
                        seed=seed, steps=steps, eta=eta, x_T=x_T,
                        device=params_device(bundle.q_params))
    return x0
