"""The step-latency floor of the DIA chain on a CUDA card: what one step's
barrier costs with no work around it, the floor that the chain's
operations bound (0.0015 ms for 1,024 steps of the 10^4-row band) does not
see.  Kernels of ``scripts/torch_chain_probe.cu``, each a loop of k empty
steps in one launch:

- ``cluster.sync()`` in one cluster of C = 1, 2, 4, 8, 16 CTAs (the
  cluster chain's barrier, ``csrc/dia.cu`` SPLIT = false);
- the split form, arrive then wait (SPLIT = true, with no work between);
- one read of the next CTA's shared memory then ``cluster.sync()`` (the
  halo read a step adds);
- a barrier with the next CTAs only: arrive on the neighbours' mbarriers
  through distributed shared memory, wait on the own (``nbr_us``);
- ``grid.sync()`` in a cooperative grid of 40 CTAs of 256 threads (the grid
  chain's launch for 10^4 rows) and of 132.

Each at 1,024, 640, 256, 160 and 128 threads a CTA.  Time per step: CUDA
events over 20 launches at k = 1,024 less 20 at k = 0, over 20 × 1,024
steps.

Then where a 16-CTA cluster of the chain's footprint lands (distinct SMs),
and the chain kernel itself (``csrc/dia.cu``) on the 10⁴-row band of
``chip_smoke.py`` at k = 1,024, f32, 16 CTAs of the plan's 160 and of
640 threads, against variants built from edited copies of its source:
``no_push`` (no halo stores), ``barrier_only`` (no rows but the last
step's), ``late_barrier`` (one barrier, before the last step),
``relaxed`` (a relaxed arrive: no MEMBAR), ``clocks`` and
``clocks_no_push`` (``clock64()`` stamps: per CTA, the slowest thread's
cycles a step in the rows and thread 0's in the barrier, and from them and
the step's time the SM clock).  All but ``base`` and ``clocks`` give wrong
results by design and are not checked; they only split the step's time.
Each variant's barrier instructions in the step loop are printed, from
its SASS (cuobjdump).

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_chain_probe.py
"""
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import chip_smoke as cs
from sparsemat_tpu_torch import _build
from sparsemat_tpu_torch.kernels import dia as kd

K = 1024
REPS = 20
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_chain_probe.cu")


def load():
    lib = ctypes.CDLL(_build.compile_shared(
        "chain_probe", [_build.find_nvcc()] + _build.NVCC_FLAGS, [_SRC]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_cluster.argtypes = [i32, i32, i32, i32, vp, vp]
    lib.probe_grid.argtypes = [i32, i32, i32, vp]
    lib.probe_smid.argtypes = [i32, i32, i32, vp, vp]
    lib.probe_error_string.argtypes = [i32]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def us_per_step(launch):
    """µs per empty step of ``launch(k)`` (which returns the C call's code)."""
    def run(k):
        rc = launch(k)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    run(K)
    torch.cuda.synchronize()
    ms = {}
    for k in (0, K):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            run(k)
        end.record()
        end.synchronize()
        ms[k] = start.elapsed_time(end)
    return (ms[K] - ms[0]) / (REPS * K) * 1e3


#: edits of csrc/dia.cu: variant → [(text, its replacement), ...]
_STEP = """    cluster_step<T, false>(c, s, out);
"""
_LOOP = """  for (int s = 0; s + 1 < k; ++s) {
""" + _STEP + """    step_barrier(cluster);
  }
"""
# the loop with clock64() stamps: per CTA, the slowest thread's cycles in
# the rows (sums, stores, pushes) and thread 0's in the barrier, written
# over `out` after a last barrier (the last step's rows come after them)
_CLOCKED = """  long long t_rows = 0, t_bar = 0;
  for (int s = 0; s + 1 < k; ++s) {
    const long long t0 = clock64();
""" + _STEP + """    const long long t1 = clock64();
    step_barrier(cluster);
    t_rows += t1 - t0;
    t_bar += clock64() - t1;
  }
  __shared__ unsigned long long s_max;
  if (tid == 0) s_max = 0;
  cluster.sync();
  atomicMax(&s_max, static_cast<unsigned long long>(t_rows));
  __syncthreads();
  if (tid == 0) {
    long long* st = reinterpret_cast<long long*>(out) + 2 * rank;
    st[0] = static_cast<long long>(s_max);
    st[1] = t_bar;
  }
  if (k > 0) return;
"""
_NO_PUSH = ("        push(c, (s + 1) & 1, r[u], acc[u]);\n", "")
VARIANTS = {
    "base": [],
    "no_push": [_NO_PUSH],
    "barrier_only": [(_STEP, "")],
    "late_barrier": [("    step_barrier(cluster);\n  }", "    if (s + 2 == k) step_barrier(cluster);\n  }")],
    "relaxed": [("  cluster.sync();\n}", '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n\\t"\n'
                                        '               "barrier.cluster.wait.aligned;" ::: "memory");\n}')],
    "clocks": [(_LOOP, _CLOCKED)],
    "clocks_no_push": [_NO_PUSH, (_LOOP, _CLOCKED)],
}
#: instructions of a barrier's SASS
_BARRIER_SASS = ("MEMBAR", "FENCE", "ERRBAR", "UCGABAR", "CCTL", "BAR.SYNC")


def variant_lib(name):
    """csrc/dia.cu with one edit, built and bound (its cluster chain)."""
    src = open(os.path.join(_build.CSRC_DIR, "dia.cu")).read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: its edit does not apply")
        src = src.replace(old, new)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"dia_probe_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = _build.compile_shared(f"dia_probe_{name}", [_build.find_nvcc()] + _build.NVCC_FLAGS,
                               [path])
    lib = ctypes.CDLL(so)
    lib.sass = barrier_sass(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.smt_dia_chain_cluster_f32.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp, vp,
                                              i32, i32, i32, i32, vp]
    return lib


def barrier_sass(so):
    """The barrier instructions of the f32 cluster chain kernel in ``so``,
    in order (cuobjdump beside nvcc)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=120).stdout
    out, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = "dia_chain_cluster_kernelIf" in ln
        elif inside and any(w in ln for w in _BARRIER_SASS):
            out.append(ln.split(";")[0].split("*/")[-1].strip())
    return out


def chain_variants(stream):
    """µs per step of each variant of the cluster chain on the 10⁴-row band."""
    dev = torch.device("cuda", 0)
    g = cs.gen(dev)
    A = cs.averaging_dia(10_000, 10_000, (-100, -1, 0, 1, 100), torch.float32, g)
    x = torch.randn(10_000, generator=g, device=dev)
    out = torch.empty_like(x)
    lo, hi = kd.chain_halos(A.offsets, 10_000)
    plans = [kd.cluster_plan(A, torch.float32, 16, t) for t in (None, 1024)]
    libs = {name: variant_lib(name) for name in VARIANTS}
    rows = []
    for plan in plans:
        for name, lib in libs.items():
            def launch(k, lib=lib, plan=plan):
                return lib.smt_dia_chain_cluster_f32(
                    A.data.data_ptr(), A.offsets_dev.data_ptr(), len(A.offsets), 10_000,
                    plan.rows, lo, hi, x.data_ptr(), out.data_ptr(), k, plan.blocks,
                    plan.threads, plan.smem, stream)
            row = {"variant": name, "ctas": plan.blocks, "threads": plan.threads,
                   "us_per_step": us_per_step(launch), "barrier_sass": lib.sass}
            if name.startswith("clocks"):
                launch(K)
                torch.cuda.synchronize()
                st = out.view(torch.int64)[:2 * plan.blocks].reshape(plan.blocks, 2).cpu()
                row["rows_cycles_per_step"] = (st[:, 0].double() / K).tolist()
                row["barrier_cycles_per_step"] = (st[:, 1].double() / K).tolist()
                row["mhz"] = float(st.sum(1).max()) / K / row["us_per_step"]
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def placement(lib, stream):
    """Distinct SMs of a 16-CTA cluster at the chain's footprints."""
    smid = torch.zeros(16, dtype=torch.int32, device="cuda")
    rows = []
    for threads, smem in ((160, 19_120), (640, 19_120), (160, 22_420), (1024, 36_620)):
        rc = lib.probe_smid(16, threads, smem, smid.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(lib.probe_error_string(rc).decode())
        torch.cuda.synchronize()
        row = {"ctas": 16, "threads": threads, "smem": smem,
               "distinct_sms": len(set(smid.tolist()))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_chain_probe: torch finds no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.zeros(1, device="cuda")
    rows = []
    for threads in (1024, 640, 256, 160, 128):
        for c in (1, 2, 4, 8, 16):
            row = {"barrier": "cluster", "ctas": c, "threads": threads}
            for name, kind in (("sync_us", 0), ("split_us", 1), ("dsmem_sync_us", 2),
                               ("nbr_us", 3)):
                try:
                    row[name] = us_per_step(lambda k, kind=kind: lib.probe_cluster(
                        kind, c, threads, k, sink.data_ptr(), stream))
                except RuntimeError as e:
                    row[name] = f"refused: {e}"
            rows.append(row)
            print(json.dumps(row), flush=True)
        for blocks in (40, 132) if threads in (256, 128) else ():
            row = {"barrier": "grid", "ctas": blocks, "threads": threads}
            row["sync_us"] = us_per_step(lambda k: lib.probe_grid(
                blocks, row["threads"], k, stream))
            rows.append(row)
            print(json.dumps(row), flush=True)
    where = placement(lib, stream)
    variants = chain_variants(stream)
    torch.cuda.synchronize()
    print(json.dumps({"card": smi, "k": K, "reps": REPS, "probe": rows, "placement": where,
                      "chain_variants": variants}), flush=True)


if __name__ == "__main__":
    main()
