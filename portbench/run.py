"""The benchmark's entry: one run of one cell on the card it is started on.

    python3 portbench/run.py --workload cifar10.fid_batch --seed 7 \\
        --seconds 40 --trace 0

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error. Exits non-zero with no result when there
is no CUDA card, and when the process has loaded JAX or the JAX package
``repro`` by the time the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA card; nothing was measured",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    torch.cuda.set_device(0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    try:
        limit = os.popen("nvidia-smi --query-gpu=power.limit "
                         "--format=csv,noheader").read().strip()
    except OSError:
        limit = ""
    out["device"]["power_limit"] = limit
    checks = out.pop("checks")
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
