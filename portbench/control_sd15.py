"""The control behind an ``sd15``-family cell's limits, on the card at the
cell's own size.

    python3 portbench/control_sd15.py --workload sd15.t2i_batch --seeds 1 2 3

The control is ``reference_sd15`` put in the program's place and computed
in bfloat16 where the configuration states float32 (norms, attention,
GEGLU, the residual stream, the samplers' latents), the nearest precision
below. For each seed, on the seed's weights, x_T and contexts, it is held
against the float32 reference exactly as the harness holds the program:

* ``layer_gap``: one of its forwards at the cell's full bucket (each of a
  batch of prompts' uncond and cond rows) at a timestep drawn from the
  seed, recorded op by op;
* ``trajectory_gap``: the requests a run with that seed follows, served
  end to end by the control with the traffic's guidance, their eps and
  latents recorded at each eval.

Prints one JSON line per seed. A sound limit lies below every reading; the
program's own readings are the runs' ``checks``.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control_gaps(cell, seed: int, seconds: float, device) -> dict:
    import numpy as np
    import torch
    from portbench import check, inputs, loadgen
    from portbench import reference_sd15 as ref
    fam, cfg, traffic = cell.family, cell.cfg, cell.traffic
    scale = float(traffic.get("guidance_scale", 0.0))
    drawn = fam.draw(cell, seed, seconds, device)
    ctx, null = drawn.contexts, drawn.null_context
    weights = ref.Weights(drawn.params, drawn.hubs, drawn.router, cfg)

    # one forward at the full bucket: prompt i's uncond and cond rows
    b = loadgen.buckets(dict(traffic, max_batch=2 * traffic["max_batch"]))[-1]
    x = inputs.noise(cfg, drawn.gen, b // 2).repeat_interleave(2, dim=0)
    rows = [(i // 2, fam.UNCOND if i % 2 == 0 else fam.COND)
            for i in range(b)]
    context = torch.cat([null if role == fam.UNCOND else ctx[i:i + 1]
                         for i, role in rows])
    t = int(np.random.default_rng(seed).integers(cfg["T"]))
    tb = torch.full((b,), float(t), device=x.device)
    at = torch.tensor(sorted({0, b - 1}), device=x.device)
    ops, kv = [], []

    def take(v):
        return tuple(u[at].float() for u in v) if isinstance(v, tuple) \
            else v[at].float()

    class Recorded(ref.UNet):
        def _product(self, w, xx, site, stride=1):
            y = super()._product(w, xx, site, stride)
            if site.endswith(fam.CROSS_KV):
                kv.append(xx.float())
            name = "conv2d_apply" if w[site + "/w"][1].ndim == 4 else \
                "dense_apply"
            ops.append((name, take(xx), take(y)))
            return y

        def _gn(self, w, xx, site, eps=1e-5):
            y = super()._gn(w, xx, site, eps)
            ops.append(("groupnorm_apply", take(xx), take(y)))
            return y

        def _ln(self, w, xx, site):
            y = super()._ln(w, xx, site)
            ops.append(("layernorm_apply", take(xx), take(y)))
            return y

        def _attention(self, q, k, v):
            y = super()._attention(q, k, v)
            ops.append(("attention", take((q, k, v)), take(y)))
            return y

        def _geglu(self, h):
            y = super()._geglu(h)
            ops.append(("geglu", take(h), take(y)))
            return y

    with torch.inference_mode(), check.full_f32():
        eps = Recorded(cfg, torch.bfloat16)(weights.at(t), x, tb, context)
    capture = {"x": x[at], "t": tb[at], "eps": eps[at], "ops": ops,
               "rows": [rows[i] for i in at.tolist()], "kv": kv,
               "kv_rows": rows}
    out = {"layer_gap": fam.layer_gap(cfg, weights, capture, ctx, null)}
    del capture, ops, kv, eps

    # the followed requests end to end, together (a backlog's first batch
    # shares its sampler and steps)
    plain = ref.UNet(cfg, torch.bfloat16)
    follow = [r for r in drawn.reqs if r.index in drawn.follow]
    samplers = [ref.Sampler(r.sampler, cfg["T"], r.steps,
                            drawn.x_T[r.index:r.index + 1], torch.bfloat16,
                            eta=r.eta, seed=r.index) for r in follow]
    records = {r.index: [] for r in follow}
    cond = torch.cat([ctx[r.index:r.index + 1] for r in follow])
    with torch.inference_mode(), check.full_f32():
        while not samplers[0].done:
            tt = samplers[0].t
            xs = torch.cat([s.x for s in samplers])
            n = len(follow)
            if scale > 0:
                e = plain(weights.at(tt), torch.cat([xs, xs]),
                          torch.full((2 * n,), float(tt), device=xs.device),
                          torch.cat([null.expand(n, -1, -1), cond]))
                eu, ec = e[:n], e[n:]
            for i, (r, s) in enumerate(zip(follow, samplers)):
                tb1 = torch.full((1,), float(tt), device=xs.device)
                if scale > 0:
                    records[r.index] += [
                        (fam.UNCOND, tb1, s.x, eu[i:i + 1]),
                        (fam.COND, tb1, s.x, ec[i:i + 1])]
                    s.advance(ref.guided(eu[i:i + 1], ec[i:i + 1],
                                         scale).to(torch.bfloat16))
                else:
                    e = plain(weights.at(tt), s.x, tb1, cond[i:i + 1])
                    records[r.index].append((fam.PLAIN, tb1, s.x, e))
                    s.advance(e.to(torch.bfloat16))
    answers = {r.index: s.state for r, s in zip(follow, samplers)}
    out["trajectory_gap"] = fam.trajectory_gap(cfg, follow, drawn.x_T,
                                               records, answers, scale)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        gaps = control_gaps(cell, seed, spec["run_seconds"], "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **{f"control_{k}": v for k, v in gaps.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
