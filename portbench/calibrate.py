"""Read the numbers that decide ``correct``, for setting their limits: the
program's over many seeds and the control's (the plain reference in
bfloat16, one precision below the configuration's float32, put in the
program's place) over a few, each run judging as many answers as a
benchmark run does.  Not part of a benchmark run; on the CUDA card:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control reference|program]

``--control program`` puts the program's own bfloat16 path in its place
(``system.LoweredPortSystem``).  ``--traffic rtol=1e-2`` replaces a key of
the traffic mix, to read a fault at the cell's own size (here a solve
stopped two decades short).

One JSON line a seed on standard output.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None):
    import argparse

    import torch

    import harness
    from reference.system import ReferenceSystem
    from system import LoweredPortSystem

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", choices=("reference", "program"), default=None)
    p.add_argument("--traffic", action="append", default=[], metavar="KEY=JSON",
                   help="replace a key of the traffic mix (repeatable)")
    p.add_argument("--count", type=int, default=None,
                   help="ops a seed (default: the traffic's sample, all judged)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: torch finds no CUDA card")
    traffic = {k: json.loads(v) for k, v in (t.split("=", 1) for t in args.traffic)}
    cell = harness.Cell(args.workload, traffic_overrides=traffic)
    count = args.count or int(cell.traffic["sample"])
    for seed in (int(s) for s in args.seeds.split(",")):
        system = {None: None, "reference": ReferenceSystem("cuda", torch.bfloat16),
                  "program": LoweredPortSystem("cuda", torch.bfloat16)}[args.control]
        t0 = time.perf_counter()
        result, checks = harness.run(args.workload, seed, 0, 0, device="cuda",
                                     t_process=t0, system=system, count=count,
                                     traffic_overrides=traffic)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "system": f"control {args.control} bf16" if args.control else "program",
                          "traffic": traffic,
                          "ops": result["attempted"], "correct": result["correct"],
                          "checks": {c: v for c, v, _ in checks},
                          "seconds": time.perf_counter() - t0}), flush=True)
        del result
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
