"""Find an open-loop cell's knee once, on the card: the highest arrival
rate the system sustains without a growing backlog.

    python3 portbench/sweep.py --workload bedroom.online --seconds 30 \\
        --rates 0.5 1 1.5 2 3

One set-up (weights, every segment, warm buckets), then for each rate a
fresh engine on the same bank serves that rate's arrivals for
``--seconds`` as a run does. Prints one JSON line a rate: p50 and p90 from
due time, the mean batch and tick, how long the window's requests took to
drain past its end, and the p50 of the window's last third over its first
third (above 1 where the backlog grows). A run waits at most
``harness.DRAIN_LIMIT_S`` past the window.
"""
import argparse
import json
import pathlib
import sys
import time

T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import numpy as np
    import torch
    from portbench import harness, inputs, loadgen
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    cfg, device = cell.cfg, torch.device("cuda")
    gen = inputs.generator(args.seed, device)
    params, hubs, router = (inputs.params(cfg, gen), inputs.hubs(cfg, gen),
                            inputs.router(cfg, gen))
    tail = harness.TAIL_S
    most = max(len(loadgen.generate(dict(cell.traffic, rate=r), args.seed,
                                    args.seconds, tail))
               for r in args.rates)
    x_T = inputs.noise(cfg, gen, most)
    clock = harness.Clock()
    system = cell.family.System(
        cell, cell.family.Inputs(gen, params, hubs, router, [], x_T, []),
        clock, device)
    system.set_up()
    print(f"set-up {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    for rate in args.rates:
        traffic = dict(cell.traffic, rate=rate)
        reqs = loadgen.generate(traffic, args.seed, args.seconds, tail)
        clock = harness.Clock()
        system.engine = system.new_engine(traffic["max_batch"], clock)
        win = harness.Window(system, clock, args.seconds, False)
        late = win.run_open(reqs, {r.index for r in reqs if r.in_window})
        drained = clock.now() - args.seconds
        due = sorted((r.due, r.index) for r in reqs if r.in_window)
        eng = system.engine
        by_index = {rs.req.seed: rs for rs in eng.results.values()}
        lat = [by_index[i].finished_at - d for d, i in due
               if i in by_index]
        lat_by_due = [by_index[i].finished_at - d for d, i in due
                      if i in by_index]
        third = max(len(lat_by_due) // 3, 1)
        trend = (float(np.median(lat_by_due[-third:]))
                 / float(np.median(lat_by_due[:third])))
        print(json.dumps({
            "rate": rate, "requests": len(lat),
            "p50_s": loadgen.percentile(sorted(lat), 50),
            "p90_s": loadgen.percentile(sorted(lat), 90),
            "mean_batch": win.evals / max(win.forwards, 1),
            "tick_ms": 1e3 * sum(win.tick_s) / max(len(win.tick_s), 1),
            "drain_s": drained, "trend": trend,
            "late_max_ms": 1e3 * max(late)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
