"""TALoRA + DFA fine-tuning of a quantized diffusion model (paper §4.2/4.3);
port of ``repro.train.finetune``.

EfficientDM-style trajectory distillation: walk the FP teacher's DDIM
trajectory; at each timestep t the quantized student (TALoRA merged for
that t) matches the teacher's eps under the DFA-weighted loss (Eq. 9).
Only the LoRA hubs and the router train; the quantized base and the
searched quantizers stay frozen.

``loss_mode``: 'dfa' (Eq. 9) | 'plain' (Eq. 7 baseline, the ablation).
``router_mode``: 'learned' (TALoRA) | 'single' (h=1 baseline) | 'split' /
'random' (Table 1's dual-LoRA allocation strategies).

``train_step`` is the reference's inner (jitted) step as a function of
its own. It runs whole, forward, backward and Adam, with TF32 off: cuDNN
would otherwise take the backward convs in TF32, which the reference's
f32 does not. Random draws (the trajectory starts, the 'random' router
mode) come from CPU ``torch.Generator``s seeded from ``ft.seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.common.device import no_tf32
from repro_torch.common.tree import flatten_paths, tree_leaves, tree_map
from repro_torch.core import dfa, msfp, talora
from repro_torch.diffusion.pipeline import QuantizedDiffusion, params_device
from repro_torch.diffusion.samplers import ddim_step
from repro_torch.diffusion.schedule import sample_timesteps
from repro_torch.nn.unet import unet_apply
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.quant.calibrate import QuantContext

LOSS_MODES = ("dfa", "plain")
ROUTER_MODES = ("learned", "single", "split", "random")


@dataclasses.dataclass
class FinetuneConfig:
    steps_per_epoch: int = 20      # DDIM trajectory length during tuning
    epochs: int = 4
    batch: int = 8
    lr: float = 1e-4
    loss_mode: str = "dfa"         # dfa | plain
    router_mode: str = "learned"   # learned | single | split | random
    eta: float = 0.0
    seed: int = 0

    def adam(self) -> AdamConfig:
        return AdamConfig(lr=self.lr, clip_norm=1.0)


def _select_fixed(mode: str, t_frac: float, h: int,
                  gen: torch.Generator | None, device) -> torch.Tensor:
    """Non-learned allocation baselines from Table 1: a (h,) one-hot."""
    if mode == "single" or h == 1:
        slot = 0
    elif mode == "split":  # first/second half of the trajectory
        slot = 0 if t_frac > 0.5 else 1
    elif mode == "random":
        slot = int(torch.randint(0, h, (), generator=gen))
    else:
        raise ValueError(mode)
    return torch.nn.functional.one_hot(torch.tensor(slot), h).to(
        device, torch.float32)


def make_student_eps(bundle: QuantizedDiffusion, ft: FinetuneConfig):
    """(hubs, router, x, t_batch, gen, t_frac) -> eps with the routing of
    ``ft.router_mode``; the batch shares one timestep."""
    tcfg = bundle.talora_cfg
    names = sorted(bundle.hubs)
    qctx = QuantContext("quantize", plan=bundle.plan,
                        act_fn=msfp.quantize_act)

    def eps_fn(hubs, router, x, tb, gen, t_frac):
        if ft.router_mode == "learned":
            sels = talora.route(router, tb.reshape(-1)[0], names, tcfg)
        else:
            sel = _select_fixed(ft.router_mode, t_frac, tcfg.hub_size, gen,
                                x.device)
            sels = {n: sel for n in names}
        params = talora.merge_into_tree(bundle.q_params, hubs, sels, tcfg)
        return unet_apply(params, x, tb, bundle.cfg, ctx=qctx)

    return eps_fn


def train_step(bundle: QuantizedDiffusion, ft: FinetuneConfig,
               trainable: dict, opt: dict, x: torch.Tensor, tb: torch.Tensor,
               gamma_t: torch.Tensor, *, t_frac: float = 0.0,
               gen: torch.Generator | None = None):
    """One fine-tune step: the teacher's eps (no gradient), the student's
    under the loss, the gradients of every hub and router leaf, Adam.
    ``trainable`` is ``{"hubs": ..., "router": ...}``; returns (trainable,
    opt, loss, metrics) as new trees, the inputs left alone. ``metrics``
    holds the gradients and the teacher's eps, which advances the
    trajectory."""
    if ft.loss_mode not in LOSS_MODES:
        raise ValueError(f"loss_mode {ft.loss_mode!r} not in {LOSS_MODES}")
    eps_fn = make_student_eps(bundle, ft)
    with no_tf32():
        with torch.no_grad():
            eps_t = bundle.teacher_eps(x, tb)
        tr = tree_map(lambda l: l.detach().requires_grad_(True), trainable)
        eps_s = eps_fn(tr["hubs"], tr["router"], x, tb, gen, t_frac)
        if ft.loss_mode == "dfa":
            loss = dfa.dfa_loss(eps_t, eps_s, gamma_t)
        else:
            loss = dfa.plain_loss(eps_t, eps_s)
        leaves = tree_leaves(tr)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(l) if g is None else g
                   for l, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(it), tr)
        new_tr, opt, metrics = adam_update(grads, opt, tr, ft.adam())
    metrics["grads"] = grads
    metrics["eps_t"] = eps_t
    return new_tr, opt, loss.detach(), metrics


def finetune(bundle: QuantizedDiffusion, ft: FinetuneConfig, *,
             log: Callable[[str], None] | None = None
             ) -> tuple[QuantizedDiffusion, list[dict]]:
    """Runs the fine-tune; returns the bundle with trained hubs/router."""
    if bundle.hubs is None:
        raise ValueError("bundle needs TALoRA attached")
    sched, cfg = bundle.sched, bundle.cfg
    dev = params_device(bundle.q_params)
    seq = sample_timesteps(sched.T, ft.steps_per_epoch)
    gammas = sched.gamma().numpy()
    trainable = {"hubs": bundle.hubs, "router": bundle.router}
    opt = adam_init(trainable, ft.adam())
    gen = torch.Generator().manual_seed(ft.seed)
    logs = []
    for epoch in range(ft.epochs):
        shape = (ft.batch, cfg.image_size, cfg.image_size, cfg.in_ch)
        x = torch.randn(shape, generator=gen).to(dev)
        ep_losses = []
        for i, t in enumerate(seq):
            tb = torch.full((ft.batch,), float(t), dtype=torch.float32,
                            device=dev)
            gamma_t = torch.full((ft.batch,), float(gammas[int(t)]),
                                 dtype=torch.float32, device=dev)
            trainable, opt, loss, m = train_step(
                bundle, ft, trainable, opt, x, tb, gamma_t,
                t_frac=float(t) / sched.T, gen=gen)
            ep_losses.append(float(loss))
            # advance the trajectory with the TEACHER's prediction (the
            # student's input distribution follows the FP trajectory)
            t_prev = int(seq[i + 1]) if i + 1 < len(seq) else -1
            x = ddim_step(sched, x, int(t), t_prev, m["eps_t"], ft.eta)
        logs.append({"epoch": epoch, "loss": float(np.mean(ep_losses))})
        if log:
            log(f"epoch {epoch}: loss={np.mean(ep_losses):.5f}")
    bundle.hubs = trainable["hubs"]
    bundle.router = trainable["router"]
    return bundle, logs


@torch.no_grad()
def eval_denoising_gap(bundle: QuantizedDiffusion, ft: FinetuneConfig, *,
                       seed: int = 0, steps: int = 20, batch: int = 8,
                       x_T: torch.Tensor | None = None) -> dict[str, float]:
    """Paper Fig. 3 metric: per-step MSE(x_{t-1}^fp, x_{t-1}^quant) along
    the FP trajectory, and the final-image MSE (the FID proxy used here)."""
    sched, cfg = bundle.sched, bundle.cfg
    dev = params_device(bundle.q_params)
    seq = sample_timesteps(sched.T, steps)
    eps_fn = make_student_eps(bundle, ft)
    gen = torch.Generator().manual_seed(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.in_ch)
    x_fp = (torch.randn(shape, generator=gen) if x_T is None
            else torch.as_tensor(x_T)).to(dev, torch.float32)
    x_q = x_fp
    gaps, eps_mses = [], []
    with no_tf32():
        for i, t in enumerate(seq):
            tb = torch.full((batch,), float(t), dtype=torch.float32,
                            device=dev)
            t_frac = float(t) / sched.T
            e_fp = unet_apply(bundle.fp_params, x_fp, tb, cfg)
            e_q = eps_fn(bundle.hubs, bundle.router, x_fp, tb, gen, t_frac)
            eps_mses.append(float(torch.mean((e_fp - e_q) ** 2)))
            t_prev = int(seq[i + 1]) if i + 1 < len(seq) else -1
            x_next_fp = ddim_step(sched, x_fp, int(t), t_prev, e_fp)
            x_next_q = ddim_step(sched, x_fp, int(t), t_prev, e_q)
            gaps.append(float(torch.mean((x_next_fp - x_next_q) ** 2)))
            # full-trajectory divergence for the final-image metric
            e_q_traj = eps_fn(bundle.hubs, bundle.router, x_q, tb, gen,
                              t_frac)
            x_q = ddim_step(sched, x_q, int(t), t_prev, e_q_traj)
            x_fp = x_next_fp
    final_mse = float(torch.mean((x_fp - x_q) ** 2))
    return {"final_image_mse": final_mse,
            "mean_step_gap": float(np.mean(gaps)),
            "mean_eps_mse": float(np.mean(eps_mses)),
            "step_gaps": gaps, "eps_mses": eps_mses}


# A step held against another of the same state (card against CPU): the
# relative Frobenius error of the loss, the grad norm, each leaf's
# gradient, each leaf's change and each moment, largest over the leaves.
STEP_LIMIT = 1e-3


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def step_errors(got: dict, want: dict, before: dict) -> dict[str, float]:
    """``got``/``want``: {"tr", "opt", "loss", "grad_norm", "grads"} of one
    step each from the trainable tree ``before``; leaves whose reference
    value is 0 (an untouched gradient, change or moment) are skipped."""
    err = {"loss": _rel(got["loss"], want["loss"]),
           "grad_norm": _rel(got["grad_norm"], want["grad_norm"])}
    pairs = {"grads": (got["grads"], want["grads"], None),
             "leaves": (got["tr"], want["tr"], before),
             "m": (got["opt"]["m"], want["opt"]["m"], None),
             "v": (got["opt"]["v"], want["opt"]["v"], None)}
    for what, (g, w, base) in pairs.items():
        fg, fw = flatten_paths(g), flatten_paths(w)
        fb = flatten_paths(base) if base is not None else None
        errs = [0.0]
        for k, wv in fw.items():
            gv = fg[k].cpu()
            wv = wv.cpu()
            if fb is not None:
                gv, wv = gv - fb[k].cpu(), wv - fb[k].cpu()
            if bool(wv.any()):
                errs.append(_rel(gv, wv))
        err[what] = max(errs)
    return err
