"""One run of one cell: set-up, a measured window (or, with ``trace``, a
profiled slice), the judgement of what the window produced, and the result.

Everything a cell is made of is found by name: the workload in
``BENCHMARK.json``, its configuration's file and the generator that file
names (``configs/<generator>.py``), its traffic mix (``traffic/<mix>.json``),
its limits (``limits/<workload>.json``) and a reader for each metric
(``metrics/<metric>.py``, a ``read(run)`` that returns a number or None).
A cell that a later change adds brings its own files and edits none here.
"""

import importlib.util
import json
import os
import random
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsemat_tpu")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    name = "portbench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """A workload of ``BENCHMARK.json`` and the files it names.
    ``overrides`` and ``traffic_overrides`` replace keys of the
    configuration and of the traffic mix (the CPU tests shrink them)."""

    def __init__(self, workload, bench=None, overrides=None, traffic_overrides=None):
        bench = bench if bench is not None else load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.workload = cells[workload]
        entry = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = dict(load_json(os.path.join(ROOT, entry["file"])), **(overrides or {}))
        self.traffic = dict(load_json(os.path.join(HERE, "traffic",
                                                   self.workload["traffic"] + ".json")),
                            **(traffic_overrides or {}))
        self.limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
        self.generator = load_module(os.path.join(HERE, "configs",
                                                  self.config["generator"] + ".py"))
        self.dtype = DTYPES[self.config["dtype"]]
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]

    def triplets(self, seed):
        """(rows, cols, values in the configuration's dtype, shape)."""
        rows, cols, vals, shape = self.generator.triplets(self.config, seed)
        return rows, cols, vals.astype(self.config["dtype"]), tuple(int(s) for s in shape)

    def bound_s(self, nnz, shape):
        """The roofline bound of one product of the traffic's columns, each
        stored value counted at the configuration dtype's bytes."""
        import roofline

        return roofline.product_bound_s(nnz, shape[0], shape[1],
                                        int(self.traffic.get("columns", 1)),
                                        value_bytes=torch.finfo(self.dtype).bits // 8)[0]

    def pool(self, seed, n, device):
        """The traffic's inputs, made on the device from the seed in one
        call: ``pool`` vectors of n, or blocks of (n, columns)."""
        t = self.traffic
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        cols = int(t.get("columns", 1))
        shape = (int(t["pool"]), n) if cols == 1 else (int(t["pool"]), n, cols)
        return torch.randn(shape, generator=g, device=device, dtype=self.dtype)


class Keep:
    """A uniform sample, drawn from the seed, of ``k`` answers of the window
    (reservoir sampling): (op index, answer)."""

    def __init__(self, k, seed):
        self.k, self.rng, self.items = int(k), random.Random(seed), []

    def offer(self, i, answer):
        if len(self.items) < self.k:
            self.items.append((i, answer))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.items[j] = (i, answer)


def run_solves(system, A, M, pool, traffic, keep, seconds=None, count=None, min_ops=1):
    """Solves back to back, b_i = pool[i mod P], until ``seconds`` have
    passed (and ``min_ops`` solves are done) or ``count`` solves are done;
    the last solve started always finishes."""
    lat, its, conv = [], [], []
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        x, it, ok = system.solve(A, pool[i % pool.shape[0]], M, traffic)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        its.append(it)
        conv.append(ok)
        keep.offer(i, x)
        i += 1
        if count is not None:
            if i >= count:
                break
        elif t1 - t_start >= seconds and i >= min_ops:
            break
    return {"seconds": t1 - t_start, "ops": i, "latencies": lat, "iterations": its,
            "converged": conv}


def run_products(system, A, pool, keep, seconds=None, count=None, min_ops=1):
    """Products back to back, X_i = pool[i mod P], with no wait between them,
    until ``seconds`` have passed (and ``min_ops`` are issued) or ``count``
    are issued; then the device is synchronised."""
    t_start = time.perf_counter()
    i = 0
    while True:
        keep.offer(i, system.product(A, pool[i % pool.shape[0]]))
        i += 1
        if count is not None:
            if i >= count:
                break
        elif time.perf_counter() - t_start >= seconds and i >= min_ops:
            break
    system.sync()
    return {"seconds": time.perf_counter() - t_start, "ops": i}


def profiled(fn, span):
    """(fn's result, reduction of its device trace): ``fn`` runs inside
    ``record_function(span)`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import devtrace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(span):
            out = fn()
    events, window, host = devtrace.trace_events(prof, span)
    return out, devtrace.reduce_slice(events, window, host)


def run(workload, seed, seconds, trace, *, device, t_process, system=None, overrides=None,
        traffic_overrides=None, count=None, say=None):
    """One run of ``workload``: returns (result dict, [(check, value, limit)]).

    ``system`` is the program (``system.PortSystem``) unless the control or
    a broken program stands in its place; ``count`` runs that many ops in
    place of a window of ``seconds`` (the calibration's runs)."""
    say = say or (lambda *a: None)
    t_enter = time.perf_counter()
    device = torch.device(device)
    if system is None:
        from system import PortSystem

        system = PortSystem(device)
    cell = Cell(workload, overrides=overrides, traffic_overrides=traffic_overrides)
    cfg, traffic = cell.config, cell.traffic
    seed = int(seed) % 2**64
    dtype = cell.dtype
    solve = traffic["kind"] == "solve"
    sync = system.sync

    # --- set-up ----------------------------------------------------------------
    rows, cols, vals, shape = cell.triplets(seed)
    n = shape[0]
    pool = cell.pool(seed, n, device)
    t0 = time.perf_counter()
    csr = system.assemble(rows, cols, vals, shape, dtype)
    sync()
    t1 = time.perf_counter()
    A = system.freeze(csr, cfg["format"])
    if solve:
        system.matvec_dot(A, pool[0])
    else:
        system.product(A, pool[0])
    sync()
    t2 = time.perf_counter()
    M = system.preconditioner(csr, cfg.get("preconditioner")) if solve else None
    t3 = time.perf_counter()
    del rows, cols, vals
    # the warm-up's answers are held at once, so that the caching allocator
    # already has the blocks that the window's sample of answers keeps alive
    if solve:
        warm = [system.solve(A, pool[i % pool.shape[0]], M, traffic,
                             maxiter=traffic["warm_maxiter"])[0]
                for i in range(int(traffic["warm_ops"]))]
    else:
        warm = [system.product(A, pool[i % pool.shape[0]])
                for i in range(int(traffic["warm_ops"]))]
    del warm
    sync()
    setup_s = time.perf_counter() - t_process
    say(f"set-up {setup_s:.3f} s: imports {t_enter - t_process:.3f} s, inputs from the seed "
        f"{t0 - t_enter:.3f} s, assemble {t1 - t0:.3f} s, freeze and first product "
        f"{t2 - t1:.3f} s, preconditioner {t3 - t2:.3f} s, warm-up "
        f"{t_process + setup_s - t3:.3f} s, format {system.describe(A)}, {n} rows")

    # --- the window, or the profiled slice ----------------------------------------
    keep = Keep(traffic["sample"], seed)
    rec = {"kind": traffic["kind"], "columns": int(traffic.get("columns", 1)),
           "setup": {"setup_s": setup_s, "assemble_s": t1 - t0, "freeze_s": t2 - t1}}
    if solve:
        def loop(**kw):
            return run_solves(system, A, M, pool, traffic, keep, **kw)
    else:
        def loop(**kw):
            return run_products(system, A, pool, keep, **kw)
    if count is not None:
        rec["window"] = loop(count=count)
    elif not trace:
        rec["window"] = loop(seconds=seconds)
    else:
        rec["window"], rec["slice"] = profiled(
            lambda: loop(seconds=traffic["trace_seconds"], min_ops=traffic["trace_min_ops"]),
            "portbench.slice")
        if solve:
            burst = int(traffic["matvec_burst"])

            def matvec_burst():
                for i in range(burst):
                    system.matvec_dot(A, pool[i % pool.shape[0]])
                sync()
            _, rec["burst"] = profiled(matvec_burst, "portbench.burst")
            rec["burst"]["ops"] = burst
    win = rec["window"]
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if trace and device.type == "cuda":
        import card

        info = card.smi()
        info["copy_rate_bytes_per_s"] = card.copy_rate_bytes_per_s(device)
        print("card " + json.dumps(info), flush=True)
    del A, csr, M
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- judge what the window produced -------------------------------------------
    checks, failed = judge(cell, seed, keep, win, device, rec)
    correct = all(v <= lim for _, v, lim in checks)
    say(f"window {win['ops']} ops in {win['seconds']:.3f} s; judged {len(keep.items)}")

    metrics = {}
    for m in (cell.end_to_end if not trace else cell.per_layer):
        value = load_module(os.path.join(HERE, "metrics", m["name"] + ".py")).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win["ops"]), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and "slice" in rec:
        dev["busy_s"] = rec["slice"]["busy_s"]
        dev["window_s"] = rec["slice"]["window_s"]
        result["breakdown"] = {"device_ops": rec["slice"]["device_ops"],
                               "idle_gaps": rec["slice"]["idle_gaps"]}
    result["checks"] = {c: {"value": _finite(v), "limit": lim} for c, v, lim in checks}
    say(f"{'per-layer' if trace else 'end-to-end'} metrics: " + ", ".join(f"{k} {v['value']}" for k, v in metrics.items()))
    return result, checks


def _finite(v):
    """v, or a huge finite number in place of inf or NaN (strict JSON has
    neither)."""
    return v if v == v and abs(v) != float("inf") else 1e300


def judge(cell, seed, keep, win, device, rec):
    """The numbers compared, each with its limit: the sampled answers of the
    window against the f64 reference, rebuilt from the cell's triplets made
    anew from the seed, on inputs made anew from the seed.  Also sets the
    roofline bound of one product in ``rec``.  Returns (checks, failed)."""
    from reference.operator import TripletOperator, relative_residual, row_error

    rows, cols, vals, shape = cell.triplets(seed)
    op = TripletOperator(rows, cols, vals, shape, dtype=torch.float64, device=device)
    del rows, cols, vals
    pool = cell.pool(seed, shape[0], device)
    lim = cell.limits
    rec["bound_s"] = cell.bound_s(op.nnz, shape)
    checks = []
    if cell.traffic["kind"] == "solve":
        res = [relative_residual(op, x, pool[i % pool.shape[0]]) for i, x in keep.items]
        failed = sum(1 for ok in win["converged"] if not ok)
        checks.append(("residual", max(res, default=float("inf")), lim["residual"]))
        checks.append(("not_converged", failed, lim["not_converged"]))
    else:
        errs = [row_error(op, y, pool[i % pool.shape[0]]) for i, y in keep.items]
        failed = 0
        checks.append(("row_error", max(errs, default=float("inf")), lim["row_error"]))
    return checks, failed
