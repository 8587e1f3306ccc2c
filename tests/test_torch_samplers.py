"""The samplers' group advance against the per-request one, on the CPU.

``sampler_advance_group`` advances many one-row requests in one pass; every
row must get the bits ``sampler_advance`` gives it, step after step, and the
engine must serve the same answers on the group path as through a
substituted per-request ``sampler_advance`` (its fall-back). Imports no JAX:
``tests/test_torch_gpu.py`` runs ``check_group_case`` and
``serve_both_paths`` on the card."""
import dataclasses

import pytest
import torch

from repro_torch.configs.diffusion_presets import tiny_ddim
from repro_torch.diffusion import samplers
from repro_torch.diffusion.samplers import (sampler_advance,
                                            sampler_advance_group,
                                            sampler_init)
from repro_torch.diffusion.schedule import make_schedule
from repro_torch.launch.serve_diffusion import TALORA_CFG
from repro_torch.nn.unet import io_sites, unet_init
from repro_torch.quant.fakequant import QuantizerParams
from repro_torch.serving import (DiffusionServingEngine, VirtualClock,
                                 WeightBank, absmax_talora_setup)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.replay import record_ticks

SHAPE = (1, 4, 4, 3)
FIELDS = ("kind", "i", "done", "phase", "t_mid", "eta")

# (kind, steps, eta, tick the request joins)
CASES = {
    "ddim": [("ddim", 8, 0.0, 0), ("ddim", 8, 0.0, 0), ("ddim", 8, 0.0, 0)],
    "plms_every_history": [("plms", 7, 0.0, 0), ("plms", 7, 0.0, 0)],
    "dpm_both_phases_and_final": [("dpm_solver2", 5, 0.0, 0),
                                  ("dpm_solver2", 5, 0.0, 0)],
    "dpm_one_step": [("dpm_solver2", 1, 0.0, 0), ("dpm_solver2", 1, 0.0, 0)],
    "ddim_eta": [("ddim", 6, 0.5, 0), ("ddim", 6, 1.0, 0),
                 ("ddim", 6, 0.5, 1)],
    "mixed": [("ddim", 9, 0.0, 0), ("ddim", 5, 0.0, 2), ("ddim", 6, 0.7, 1),
              ("plms", 8, 0.0, 0), ("plms", 6, 0.0, 1), ("plms", 6, 0.0, 3),
              ("plms", 4, 0.5, 2), ("dpm_solver2", 5, 0.0, 0),
              ("dpm_solver2", 4, 0.0, 1), ("dpm_solver2", 1, 0.0, 2)],
    "one_row": [("ddim", 5, 0.0, 0)],
}


def _assert_same(a, b):
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ("x", "u", "h"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert torch.equal(va, vb), f
    assert len(a.old_eps) == len(b.old_eps)
    assert all(torch.equal(p, q) for p, q in zip(a.old_eps, b.old_eps))


def check_group_case(case: str, dev) -> None:
    """Advance ``CASES[case]`` on ``dev`` per request and as groups, the
    same eps for both, until done; every state equal bit for bit after
    every step."""
    sched = make_schedule("linear", 100)
    specs = CASES[case]

    def make():
        return [sampler_init(k, sched, SHAPE, seed=10 + j, steps=s, eta=e,
                             device=dev)
                for j, (k, s, e, _) in enumerate(specs)]
    ref, grp = make(), make()
    gen, perm_gen = torch.Generator().manual_seed(1), torch.Generator()
    perm_gen.manual_seed(2)
    seen, tick = set(), 0
    while not all(st.done for st in ref):
        live = [j for j, (*_, start) in enumerate(specs)
                if start <= tick and not ref[j].done]
        # rows in a shuffled order: the group path may not lean on it
        live = [live[k] for k in torch.randperm(len(live),
                                                generator=perm_gen)]
        eps = torch.randn((len(live),) + SHAPE[1:], generator=gen).to(dev)
        for r, j in enumerate(live):
            sampler_advance(ref[j], eps[r:r + 1])
        seen.update((grp[j].phase, len(grp[j].old_eps)) for j in live)
        n = sampler_advance_group([grp[j] for j in live], eps)
        assert 1 <= n <= len(live)
        for a, b in zip(ref, grp):
            _assert_same(a, b)
        tick += 1
    assert all(st.done for st in grp)
    if case == "plms_every_history":
        assert {h for _, h in seen} == {0, 1, 2, 3}
    if case == "dpm_both_phases_and_final":
        assert {p for p, _ in seen} == {0, 1, 2}


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_advance_is_per_request_bit_for_bit(case):
    check_group_case(case, torch.device("cpu"))


# ---------------------------------------------------------------------------
# The engine: group path against a substituted per-request advance.
# ---------------------------------------------------------------------------

# (sampler, steps, y, guidance, arrival): plain, labelled and guided rows,
# several in lockstep, so that sub-groups hold more than one row
REQUESTS = [("ddim", 6, None, 0.0, 0.0), ("ddim", 6, 1, 2.71, 0.0),
            ("ddim", 6, 2, 0.0, 0.0), ("ddim", 6, None, 0.0, 0.0),
            ("plms", 5, 1, 1.37, 0.0), ("plms", 5, None, 0.0, 0.0),
            ("plms", 5, 0, 1.5, 0.3), ("dpm_solver2", 4, None, 0.0, 0.0),
            ("dpm_solver2", 4, 0, 1.5, 0.0), ("dpm_solver2", 3, 2, 0.0, 0.2),
            ("ddim", 4, 1, 0.83, 0.4), ("plms", 4, 2, 0.0, 0.5)]


def serve_both_paths(dev) -> dict:
    """Serve ``REQUESTS`` on a class-conditional tiny_ddim(8) twice on
    ``dev``, under the virtual clock: on the group path, and with the
    engine's ``sampler_advance`` replaced by a wrapper (the per-request
    path). Returns each run's x0 (on the CPU), outcomes, tick log and
    stats."""
    cfg = dataclasses.replace(tiny_ddim(8), num_classes=3)
    gen = torch.Generator().manual_seed(0)
    params = unet_init(gen, cfg, "cpu")
    # an eps of the latents' size (conv_out starts near zero, and an eps
    # ulp would vanish in x), and a class table that moves eps past the
    # act snaps, so eps_c != eps_u
    params["conv_out"]["w"] = params["conv_out"]["w"] * 1e4
    params["class_emb"]["table"] = params["class_emb"]["table"] * 1000
    plan, hubs, router = absmax_talora_setup(params, TALORA_CFG, gen,
                                             io_sites=io_sites(params))
    runs = {}
    for path in ("group", "per_request"):
        bank = WeightBank(params, plan, hubs, router, TALORA_CFG, 100,
                          device=dev)
        eng = DiffusionServingEngine(
            cfg, make_schedule("linear", 100), bank,
            act_qps={"*": QuantizerParams(0, 2, 1, 4,
                                          torch.tensor(6.0, device=dev))},
            max_batch=8, clock=VirtualClock(), device=dev)
        ticks = record_ticks(eng)
        for j, (kind, steps, y, s, at) in enumerate(REQUESTS):
            eng.submit(sampler=kind, steps=steps, seed=j, y=y,
                       guidance_scale=s, arrival=at)
        if path == "per_request":
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(engine_mod, "sampler_advance",
                           lambda st, eps: samplers.sampler_advance(st, eps))
                res = eng.run()
        else:
            res = eng.run()
        runs[path] = {"x0": {r: rs.x0.cpu() for r, rs in res.items()},
                      "outcomes": {r: (rs.n_evals, rs.expired)
                                   for r, rs in res.items()},
                      "ticks": ticks, "stats": eng.stats()}
    return runs


def test_engine_group_path_serves_the_per_request_answers():
    runs = serve_both_paths(torch.device("cpu"))
    grp, ref = runs["group"], runs["per_request"]
    assert sorted(grp["x0"]) == list(range(len(REQUESTS)))
    assert all(torch.equal(grp["x0"][r], ref["x0"][r]) for r in ref["x0"])
    assert grp["outcomes"] == ref["outcomes"]
    assert grp["ticks"] == ref["ticks"]
    assert ref["stats"]["advance_groups"] == 0
    assert ref["stats"]["advance_group_rows"] == 0
    assert grp["stats"]["advance_group_rows"] == sum(
        n for n, _ in grp["outcomes"].values())
    assert 0 < grp["stats"]["advance_groups"] < grp["stats"][
        "advance_group_rows"]
