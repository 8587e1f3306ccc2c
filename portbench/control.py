"""The control behind a UNet-family cell's limits, on the card at the
cell's own size.

    python3 portbench/control.py --workload bedroom.online --seeds 1 2 3

The control is the reference put in the program's place and computed in
bfloat16 where the configuration states float32 (norms, attention, the
residual stream, the samplers' latents), the nearest precision below. For
each seed, on the seed's weights and x_T, it is held against the float32
reference exactly as the harness holds the program:

* ``layer_gap``: one of its forwards at the cell's batch (a backlog's full
  bucket; one row under open-loop traffic) at a timestep drawn from the
  seed, recorded op by op;
* ``trajectory_gap``: the sample of requests a run with that seed follows,
  served end to end by the control, its eps and latents recorded at each
  eval.

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
    from portbench import check, inputs, loadgen, reference
    cfg, traffic = cell.cfg, cell.traffic
    drawn = cell.family.draw(cell, seed, seconds, device)
    x_T = drawn.x_T
    b = loadgen.buckets(traffic)[-1] if traffic["process"] == "backlog" \
        else 1
    x = inputs.noise(cfg, drawn.gen, b)
    t = int(np.random.default_rng(seed).integers(cfg["T"]))
    tb = torch.full((b,), float(t), device=x.device)
    weights = reference.Weights(drawn.params, drawn.hubs, drawn.router, cfg)
    rows = torch.tensor(sorted({0, b - 1}), device=x.device)
    ops = []

    class Recorded(reference.UNet):
        def _product(self, w, xx, site, stride=1):
            y = super()._product(w, xx, site, stride)
            ops.append((xx[rows].float(), y[rows].float()))
            return y

        def _gn(self, w, xx, site):
            y = super()._gn(w, xx, site)
            ops.append((xx[rows].float(), y[rows].float()))
            return y

    net = Recorded(cfg, torch.bfloat16)
    with torch.inference_mode(), check.full_f32():
        eps = net(weights.at(t), x, tb)
    capture = {"x": x[rows], "t": tb[rows], "eps": eps[rows], "ops": ops}
    out = {"layer_gap": check.layer_gap(cfg, weights, capture)}

    plain = reference.UNet(cfg, torch.bfloat16)
    follow = [r for r in drawn.reqs if r.index in drawn.follow]
    records, answers = {}, {}
    with torch.inference_mode(), check.full_f32():
        for r in follow:
            s = reference.Sampler(r.sampler, cfg["T"], r.steps,
                                  x_T[r.index:r.index + 1], torch.bfloat16,
                                  eta=r.eta, seed=r.index)
            rec = records[r.index] = []
            while not s.done:
                tt = torch.full((1,), float(s.t), device=x.device)
                e = plain(weights.at(s.t), s.x, tt)
                rec.append((tt, s.x, e))
                s.advance(e.to(torch.bfloat16))
            answers[r.index] = s.state
    out["trajectory_gap"] = check.trajectory_gap(cfg, follow, x_T, records,
                                                 answers)
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
