"""The comparison that decides ``correct``: the program followed step by
step from its own state, each stage held against the plain reference.

A W4A4 network with random weights cannot be compared end to end: an act
snap decided the other way by one f32 ulp anywhere changes that act by a
whole grid step, and the next layers carry it on, so any reordering of a
sum moves a forward's eps by 14-50% and a served x0 by 3-6% (and the
reference in bfloat16 by the same), as the reference's own full
trajectories showed against the program on the card. So each stage is
checked from the program's own input, where rounding stays rounding:

``trajectory_gap``: for a sample of the requests (drawn from the seed; in
an open-loop cell with the one of most evals), the reference's sampler
from the same x_T (and, at eta > 0, the same noise, drawn from the seed
the request was submitted with), fed at each eval the eps the program's
forward made for that request's row, against the latent the program
evaluated at each eval and the x0 it returned: the widest relative L2
gap. It covers the start from x_T, every sampler advance, each request
getting its own row's eps at its own timestep, and the answer as
returned; a missing, extra or mistimed eval reads inf.

``layer_gap``: one forward of the program (the first after the window),
recorded op by op: the input and output rows (the batch's first and last)
of every conv, dense and GroupNorm call. The reference works out that
timestep's weights again (TALoRA merge, FP4 grid) and computes each op
from the program's own input, held against the program's output; and each
op's input against what the reference's glue (timestep embedding, SiLU,
residual adds, attention products, concat, upsample) makes from the
program's earlier outputs: the widest relative L2 gap, also over the
forward's output against the eps the engine got.

``trajectory_gap`` holds the samplers and serves any diffusion family;
``layer_gap`` holds the UNet family's model (``families/unet.py``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import reference

SAMPLE = 8


@contextlib.contextmanager
def full_f32():
    """f32 products without TF32 on the card."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = old


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in f64 (inf where a is not finite or the shapes
    differ)."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.double(), b.double()
    if not bool(torch.isfinite(a).all()):
        return float("inf")
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def pick(candidates: list, evals: dict, seed: int, longest: bool) -> list:
    """Up to ``SAMPLE`` request indices drawn from the seed; with
    ``longest``, the one with the most evaluations among them."""
    rng = np.random.default_rng([seed, 7])
    cand = sorted(candidates)
    if len(cand) <= SAMPLE:
        return cand
    if not longest:
        return sorted(rng.choice(cand, SAMPLE, replace=False).tolist())
    top = max(cand, key=lambda i: (evals[i], -i))
    rest = [i for i in cand if i != top]
    return sorted([top] + rng.choice(rest, SAMPLE - 1,
                                     replace=False).tolist())


def trajectory_gap(cfg: dict, reqs: list, x_T: torch.Tensor,
                   records: dict, answers: dict) -> float:
    """``records[index]``: the (t, x, eps) of each of the request's evals
    in the program; ``answers[index]``: its x0."""
    gap = 0.0
    with torch.inference_mode():
        for r in reqs:
            s = reference.Sampler(r.sampler, cfg["T"], r.steps,
                                  x_T[r.index:r.index + 1], eta=r.eta,
                                  seed=r.index)
            for t, x, eps in records.get(r.index, []):
                if s.done or int(t) != s.t:
                    return float("inf")
                gap = max(gap, rel(x, s.x))
                s.advance(eps)
            if not s.done or r.index not in answers:
                return float("inf")
            gap = max(gap, rel(answers[r.index], s.state))
    return gap


class _Forced(reference.UNet):
    """The reference's forward, each conv, dense and norm computed from the
    program's recorded input and continued from its recorded output."""

    def __init__(self, cfg, ops, dtype):
        super().__init__(cfg, dtype)
        self.ops = iter(ops)
        self.gap = 0.0

    def _take(self, x):
        xp, yp = next(self.ops)
        self.gap = max(self.gap, rel(x.float(), xp))
        return xp, yp

    def _product(self, w, x, site, stride=1):
        xp, yp = self._take(x)
        y = super()._product(w, xp.to(self.dtype), site, stride)
        self.gap = max(self.gap, rel(y.float(), yp))
        return yp.to(self.dtype)

    def _gn(self, w, x, site):
        xp, yp = self._take(x)
        y = super()._gn(w, xp.to(self.dtype), site)
        self.gap = max(self.gap, rel(y.float(), yp))
        return yp.to(self.dtype)


def layer_gap(cfg: dict, weights: "reference.Weights", capture: dict,
              dtype=torch.float32) -> float:
    """``capture``: ``x``, ``t`` and ``eps`` rows of one forward and
    ``ops``, its calls in order as (input rows, output rows)."""
    gap = 0.0
    with torch.inference_mode(), full_f32():
        for r in range(capture["x"].shape[0]):
            t = int(capture["t"][r])
            net = _Forced(cfg, [(x[r:r + 1], y[r:r + 1])
                                for x, y in capture["ops"]], dtype)
            try:
                out = net(weights.at(t), capture["x"][r:r + 1],
                          capture["t"][r:r + 1])
            except StopIteration:
                return float("inf")
            if next(net.ops, None) is not None:
                return float("inf")
            gap = max(gap, net.gap, rel(out, capture["eps"][r:r + 1]))
    return gap
