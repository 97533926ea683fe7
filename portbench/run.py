"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints progress and, as its last lines, each
number compared beside its limit on standard error, and as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``.  Exits non-zero, with no result, where torch finds no CUDA card,
and where JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
#: host threads of PyTorch's CPU ops: the load comes from one process with few
THREADS = 1


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import harness

    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        say(f"portbench: no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available():
        say("portbench: torch finds no CUDA card; the benchmark runs only on one")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        say(f"portbench: {args.workload} needs {cell['chips']} cards, torch finds "
            f"{torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(min(THREADS, torch.get_num_threads()))
    result, checks = harness.run(args.workload, args.seed, args.seconds, args.trace,
                                 device="cuda", t_process=T_PROCESS, say=say)
    bad = harness.forbidden_modules()
    if bad:
        say(f"portbench: the run loaded {', '.join(bad)}; no result")
        return 3
    for name, value, limit in checks:
        say(f"check {name} {value!r} limit {limit!r} "
            f"{'ok' if value <= limit else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
