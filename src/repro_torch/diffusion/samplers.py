"""Samplers: DDIM, PLMS and DPM-Solver-2; port of
``repro.diffusion.samplers``.

Two surfaces, as in the reference: the step-wise API below, and the loop
samplers (``ddim_sample``, ``plms_sample``, ``dpm_solver2_sample``), thin
drivers over the same machine that take ``eps_fn(x_t, t_batch) -> eps``.

A ``SamplerState`` is an eps-request machine: ``sampler_needed_t`` names
the timestep to evaluate next, ``state.eval_x`` the latent to evaluate at
(DPM-Solver-2's midpoint ``u``), and ``sampler_advance`` consumes the eps.
The serving engine owns the loop, and advances a tick's requests together
with ``sampler_advance_group``: the same bits, one pass a sub-group.
Per-step coefficients are f32 scalars computed on the host in the
reference's order; the DPM midpoint timestep (an argmin over the f32
log-SNR table) is decided there too, so it matches the JAX package
exactly.

``x_T`` is injectable: the reference draws it from a ``jax.random`` key,
which torch cannot reproduce, so parity tests hand the port JAX's draw.
By default it comes from a CPU ``torch.Generator`` seeded per request.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.diffusion.schedule import NoiseSchedule, sample_timesteps


def ddim_step(sched: NoiseSchedule, x_t, t: int, t_prev: int, eps,
              eta: float = 0.0, noise=None):
    """One DDIM update x_t -> x_{t_prev} (t_prev = -1 -> x0)."""
    ab_t = sched.alpha_bars[t]
    ab_p = sched.alpha_bars[t_prev] if t_prev >= 0 else torch.tensor(1.0)
    x0 = (x_t - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
    sigma = eta * torch.sqrt((1 - ab_p) / (1 - ab_t)) * torch.sqrt(1 - ab_t / ab_p)
    dir_xt = torch.sqrt(torch.clamp_min(1 - ab_p - sigma**2, 0.0)) * eps
    x_prev = torch.sqrt(ab_p) * x0 + dir_xt
    if eta > 0 and noise is not None:
        x_prev = x_prev + sigma * noise
    return x_prev


# DPM-Solver-2 phases: eps needed at (x, seq[i]) / at the midpoint (u, t_mid)
# / the final DDIM step to x0 at (x, seq[-1]).
_DPM_T, _DPM_MID, _DPM_FINAL = 0, 1, 2


@dataclasses.dataclass
class SamplerState:
    """One request's denoising trajectory, advanced one eps at a time."""

    kind: str                      # 'ddim' | 'plms' | 'dpm_solver2'
    sched: NoiseSchedule
    seq: np.ndarray                # descending timestep subsequence
    x: torch.Tensor                # current latent (B, H, W, C)
    gen: torch.Generator | None    # noise for eta > 0
    eta: float = 0.0
    i: int = 0                     # next seq index
    done: bool = False
    old_eps: list = dataclasses.field(default_factory=list)   # PLMS history
    lams: torch.Tensor | None = None
    phase: int = _DPM_T
    t_mid: int = -1
    u: torch.Tensor | None = None
    h: torch.Tensor | None = None

    @property
    def eval_x(self) -> torch.Tensor:
        """The state the next eps evaluation runs on."""
        if self.kind == "dpm_solver2" and self.phase == _DPM_MID:
            return self.u
        return self.x

    @property
    def steps_left(self) -> int:
        return 0 if self.done else len(self.seq) - self.i


def sampler_init(kind: str, sched: NoiseSchedule, shape, *, seed: int = 0,
                 steps: int = 50, eta: float = 0.0,
                 x_T: torch.Tensor | None = None,
                 device="cpu") -> SamplerState:
    """Build the request machine; ``x_T`` defaults to a draw from a CPU
    generator seeded with ``seed``."""
    if kind not in STEP_SAMPLERS:
        raise ValueError(f"unknown sampler {kind!r}")
    seq = sample_timesteps(sched.T, steps)
    gen = torch.Generator().manual_seed(seed)
    if x_T is None:
        x_T = torch.randn(shape, generator=gen)
    st = SamplerState(kind, sched, seq, x_T.to(device, torch.float32), gen,
                      eta=eta)
    if kind == "dpm_solver2":
        ab = sched.alpha_bars
        st.lams = 0.5 * torch.log(ab / (1 - ab))
        if len(seq) == 1:
            st.phase = _DPM_FINAL
    return st


def sampler_needed_t(st: SamplerState) -> int:
    """Timestep the next eps evaluation must run at (engine batching key)."""
    assert not st.done
    if st.kind == "dpm_solver2":
        if st.phase == _DPM_MID:
            return st.t_mid
        if st.phase == _DPM_FINAL:
            return int(st.seq[-1])
    return int(st.seq[st.i])


def _coeffs(sched: NoiseSchedule, t: int):
    ab = sched.alpha_bars[t]
    return torch.sqrt(ab), torch.sqrt(1 - ab)  # alpha_t, sigma_t


def _advance_ddim(st: SamplerState, eps) -> None:
    t = int(st.seq[st.i])
    t_prev = int(st.seq[st.i + 1]) if st.i + 1 < len(st.seq) else -1
    noise = None
    if st.eta > 0:
        noise = torch.randn(st.x.shape, generator=st.gen).to(st.x.device)
    st.x = ddim_step(st.sched, st.x, t, t_prev, eps, st.eta, noise)
    st.i += 1
    st.done = st.i >= len(st.seq)


def _advance_plms(st: SamplerState, eps) -> None:
    t = int(st.seq[st.i])
    t_prev = int(st.seq[st.i + 1]) if st.i + 1 < len(st.seq) else -1
    old = st.old_eps
    if len(old) == 0:
        eps_prime = eps
    elif len(old) == 1:
        eps_prime = (3 * eps - old[-1]) / 2
    elif len(old) == 2:
        eps_prime = (23 * eps - 16 * old[-1] + 5 * old[-2]) / 12
    else:
        eps_prime = (55 * eps - 59 * old[-1] + 37 * old[-2] - 9 * old[-3]) / 24
    st.old_eps = (old + [eps])[-3:]
    st.x = ddim_step(st.sched, st.x, t, t_prev, eps_prime)
    st.i += 1
    st.done = st.i >= len(st.seq)


def _advance_dpm(st: SamplerState, eps) -> None:
    if st.phase == _DPM_FINAL:
        st.x = ddim_step(st.sched, st.x, int(st.seq[-1]), -1, eps)
        st.done = True
        return
    t, t_next = int(st.seq[st.i]), int(st.seq[st.i + 1])
    if st.phase == _DPM_T:
        l_t, l_n = st.lams[t], st.lams[t_next]
        h = l_n - l_t
        l_mid = l_t + 0.5 * h
        st.t_mid = int(torch.argmin(torch.abs(st.lams - l_mid)))
        a_t, _ = _coeffs(st.sched, t)
        a_m, s_m = _coeffs(st.sched, st.t_mid)
        st.u = (a_m / a_t) * st.x - s_m * torch.expm1(0.5 * h) * eps
        st.h = h
        st.phase = _DPM_MID
        return
    # _DPM_MID: consume the midpoint eps, complete the solver step.
    a_t, _ = _coeffs(st.sched, t)
    a_n, s_n = _coeffs(st.sched, t_next)
    st.x = (a_n / a_t) * st.x - s_n * torch.expm1(st.h) * eps
    st.u = None
    st.i += 1
    st.phase = _DPM_T if st.i < len(st.seq) - 1 else _DPM_FINAL


_ADVANCE = {"ddim": _advance_ddim, "plms": _advance_plms,
            "dpm_solver2": _advance_dpm}


def sampler_advance(st: SamplerState, eps) -> SamplerState:
    """Consume the eps evaluated at (st.eval_x, sampler_needed_t(st))."""
    assert not st.done, "sampler already finished"
    _ADVANCE[st.kind](st, eps)
    return st


STEP_SAMPLERS = ("ddim", "plms", "dpm_solver2")


# ---------------------------------------------------------------------------
# Group advance: many one-row requests in one pass, the same bits.
# ---------------------------------------------------------------------------

def sampler_advance_group(states: list[SamplerState], eps) -> int:
    """``sampler_advance`` for many one-row states at once: row j of the
    (n, H, W, C) ``eps`` slab is the eps of ``states[j]``.

    The rows split into sub-groups by what each state's next update is
    (schedule, kind, DPM-Solver-2 phase, PLMS history length, eta > 0).
    A sub-group's per-row scalars are computed on the host in f32 in the
    per-request order, as vectors, and reach the device in one copy; each
    update then runs once over the sub-group's latents. Every row gets the
    bits ``sampler_advance`` gives it. The results are new slabs, whose
    rows become the states' ``x``, ``u`` and ``old_eps`` as views; no slab
    a state held is written. Returns the number of sub-groups run.
    """
    subgroups: dict[tuple, list[int]] = {}
    for j, st in enumerate(states):
        assert not st.done, "sampler already finished"
        assert st.x.shape[0] == 1, "one row a state"
        key = (id(st.sched), st.kind, st.phase, len(st.old_eps),
               _eta(st) > 0)
        subgroups.setdefault(key, []).append(j)
    for rows in subgroups.values():
        sts = [states[j] for j in rows]
        e = eps if len(rows) == len(states) else _stack(
            [eps[j:j + 1] for j in rows])
        if sts[0].kind == "dpm_solver2" and sts[0].phase != _DPM_FINAL:
            _group_dpm(sts, e)
        else:
            _group_ddim(sts, e)
    return len(subgroups)


def _group_ddim(sts, eps) -> None:
    """A DDIM update over one sub-group: DDIM's step, PLMS's (one history
    length) or DPM-Solver-2's final step to x0."""
    if sts[0].kind == "dpm_solver2":
        t = [int(st.seq[-1]) for st in sts]
        t_prev = [-1] * len(sts)
    else:
        t = [int(st.seq[st.i]) for st in sts]
        t_prev = [int(st.seq[st.i + 1]) if st.i + 1 < len(st.seq) else -1
                  for st in sts]
    e_step = eps
    if sts[0].kind == "plms":
        e_step = _plms_eps(sts, eps)
        for st, row in zip(sts, _rows(eps)):
            st.old_eps = (st.old_eps + [row])[-3:]
    noise = None
    if _eta(sts[0]) > 0:
        noise = _stack([torch.randn(st.x.shape, generator=st.gen)
                        for st in sts]).to(eps.device)
    x = _ddim_rows(sts, _stack([st.x for st in sts]), e_step, t, t_prev,
                   noise)
    for st, row in zip(sts, _rows(x)):
        st.x = row
        if st.kind == "dpm_solver2":
            st.done = True
        else:
            st.i += 1
            st.done = st.i >= len(st.seq)


def _eta(st: SamplerState) -> float:
    """The eta of the state's DDIM update: PLMS and DPM-Solver-2 run theirs
    at 0 whatever the state holds."""
    return st.eta if st.kind == "ddim" else 0.0


def _stack(rows: list) -> torch.Tensor:
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def _rows(x: torch.Tensor) -> tuple:
    """A slab's one-row views."""
    return (x,) if x.shape[0] == 1 else x.split(1)


def _to_device(table: torch.Tensor, device) -> tuple:
    """A (k, n) table of per-row host scalars in one copy to ``device``,
    as k (n, 1, 1, 1) coefficients."""
    return table.to(device).view(table.shape[0], -1, 1, 1, 1).unbind(0)


def _ddim_rows(sts, x, eps, t: list, t_prev: list, noise):
    """``ddim_step`` over one sub-group's rows (one schedule and eta sign),
    each per-row scalar by ``ddim_step``'s own ops, over (n,) vectors."""
    # alpha_bars and, at index -1 (t_prev = -1), 1.0
    ab = torch.cat([sts[0].sched.alpha_bars, torch.ones(1)])
    pair = ab[t + t_prev].view(2, -1)           # ab_t; ab_p
    rest = 1 - pair                             # 1 - ab_t; 1 - ab_p
    if noise is not None:
        eta = torch.tensor([st.eta for st in sts], dtype=torch.float32)
        sigma = eta * torch.sqrt(rest[1] / rest[0]) * torch.sqrt(
            1 - pair[0] / pair[1])
        rest[1] -= sigma**2
    # at eta 0, ddim_step's sigma is 0 and 1 - ab_p - 0 is 1 - ab_p; the
    # clamp keeps 1 - ab_t, which is positive. Rows: sqrt(1 - ab_t),
    # sqrt(1 - ab_p - sigma^2), sqrt(ab_t), sqrt(ab_p)
    table = torch.sqrt(torch.cat([torch.clamp_min(rest, 0.0), pair]))
    # torch divides a CUDA tensor by a host scalar as a product with the
    # scalar's f32 reciprocal, a CPU tensor truly; each row does the same
    recip = x.device.type == "cuda"
    if recip:
        table[2].reciprocal_()
    if noise is not None:
        table = torch.cat([table, sigma[None]])
    c_eps, c_dir, c_div, c_x0, *c_sigma = _to_device(table, x.device)
    x0 = (x - c_eps * eps) * c_div if recip else (x - c_eps * eps) / c_div
    x_prev = c_x0 * x0 + c_dir * eps
    if noise is not None:
        x_prev = x_prev + c_sigma[0] * noise
    return x_prev


def _plms_eps(sts, eps):
    """PLMS's eps' over one sub-group (one history length)."""
    old = [_stack([st.old_eps[-k] for st in sts])
           for k in range(1, len(sts[0].old_eps) + 1)]
    if len(old) == 0:
        return eps
    if len(old) == 1:
        return (3 * eps - old[0]) / 2
    if len(old) == 2:
        return (23 * eps - 16 * old[0] + 5 * old[1]) / 12
    return (55 * eps - 59 * old[0] + 37 * old[1] - 9 * old[2]) / 24


def _group_dpm(sts, eps) -> None:
    """DPM-Solver-2's midpoint or full step over one sub-group (one
    phase), each per-row scalar by ``_advance_dpm``'s own ops, over (n,)
    vectors."""
    ab, lams = sts[0].sched.alpha_bars, sts[0].lams
    t = [int(st.seq[st.i]) for st in sts]
    t_next = [int(st.seq[st.i + 1]) for st in sts]
    x = _stack([st.x for st in sts])
    if sts[0].phase == _DPM_T:
        l_t, l_n = lams[t + t_next].view(2, -1)
        h = l_n - l_t
        l_mid = l_t + 0.5 * h
        t_mid = torch.argmin(torch.abs(lams - l_mid[:, None]), dim=1)
        t_mid = t_mid.tolist()
        g = ab[t + t_mid].view(2, -1)           # ab_t; ab_mid
        a_t, a_m, s_m = torch.sqrt(torch.cat([g, 1 - g[1:]]))
        c_x, c_eps = _to_device(
            torch.stack([a_m / a_t, s_m * torch.expm1(0.5 * h)]), x.device)
        u = c_x * x - c_eps * eps
        for st, row, tm, hj in zip(sts, _rows(u), t_mid, h):
            st.u, st.t_mid, st.h, st.phase = row, tm, hj, _DPM_MID
        return
    g = ab[t + t_next].view(2, -1)              # ab_t; ab_next
    a_t, a_n, s_n = torch.sqrt(torch.cat([g, 1 - g[1:]]))
    h = torch.stack([st.h for st in sts])
    c_x, c_eps = _to_device(torch.stack([a_n / a_t, s_n * torch.expm1(h)]),
                            x.device)
    x = c_x * x - c_eps * eps
    for st, row in zip(sts, _rows(x)):
        st.x, st.u = row, None
        st.i += 1
        st.phase = _DPM_T if st.i < len(st.seq) - 1 else _DPM_FINAL


# ---------------------------------------------------------------------------
# Loop samplers: thin drivers over the step machine (same bits).
# ---------------------------------------------------------------------------

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _eps_batch(eps_fn: EpsFn, st: SamplerState, t: int) -> torch.Tensor:
    tb = torch.full((st.x.shape[0],), float(t), dtype=torch.float32,
                    device=st.x.device)
    return eps_fn(st.eval_x, tb)


def ddim_sample(eps_fn: EpsFn, sched: NoiseSchedule, shape, *, seed: int = 0,
                steps: int = 50, eta: float = 0.0, collect_every: int = 0,
                x_T: torch.Tensor | None = None, device="cpu"):
    """Full DDIM sampling loop. Returns (x0, taps): taps are (t, x_t) pairs
    (x_t a detached tensor on ``device``) every ``collect_every`` steps
    when it is > 0 (Q-Diffusion calibration sets)."""
    st = sampler_init("ddim", sched, shape, seed=seed, steps=steps, eta=eta,
                      x_T=x_T, device=device)
    taps = []
    while not st.done:
        t = sampler_needed_t(st)
        eps = _eps_batch(eps_fn, st, t)
        if collect_every and st.i % collect_every == 0:
            taps.append((t, st.x.detach().clone()))
        sampler_advance(st, eps)
    return st.x, taps


def plms_sample(eps_fn: EpsFn, sched: NoiseSchedule, shape, *, seed: int = 0,
                steps: int = 50, x_T: torch.Tensor | None = None,
                device="cpu"):
    """Pseudo Linear Multi-Step (PLMS/PNDM) sampler, 4th-order AB corrector."""
    st = sampler_init("plms", sched, shape, seed=seed, steps=steps, x_T=x_T,
                      device=device)
    while not st.done:
        sampler_advance(st, _eps_batch(eps_fn, st, sampler_needed_t(st)))
    return st.x


def dpm_solver2_sample(eps_fn: EpsFn, sched: NoiseSchedule, shape, *,
                       seed: int = 0, steps: int = 20,
                       x_T: torch.Tensor | None = None, device="cpu"):
    """DPM-Solver-2 (midpoint) in log-SNR time (Lu et al. 2022)."""
    st = sampler_init("dpm_solver2", sched, shape, seed=seed, steps=steps,
                      x_T=x_T, device=device)
    while not st.done:
        sampler_advance(st, _eps_batch(eps_fn, st, sampler_needed_t(st)))
    return st.x


SAMPLERS = {"ddim": ddim_sample, "plms": plms_sample,
            "dpm_solver2": dpm_solver2_sample}
