"""Where the merge-path RouteStream SpMV's device time goes: the kernel of
``csrc/route.cu`` on the 170,998-row circuit operator of ``chip_smoke.py``
(``matgen.circuit_scatter() * 2e-2``, its RouteStream's G = 1 plan) against
floors measured with PyTorch calls on the same arrays, and against variants
of its own source, each built from a copy of ``csrc/route.cu`` with one
change and held bitwise to the walk of its split:

- ``base``: the source as it is;
- ``occ8``: ``__launch_bounds__(THREADS, 8)``, registers capped so that 8
  CTAs of 256 threads fit an SM;
- ``t128``: 128 threads a CTA (the split built for 128);
- ``direct``: columns and values loaded straight into registers
  (coalesced, 4 or 8 bytes a thread) and multiplied by x there, only the
  row ends staged by cp.async, so x's gathers start as soon as the columns
  arrive and one pass over shared memory goes;
- ``direct+occ8``: both.

Floors: a copy of the columns and of the values (streaming the CSR's
bytes), the gather ``x[cols]`` alone, the products ``vals * x[cols]``, the
row-group SpMV over the same plan, and ``torch.mv`` on the CSR.  Device µs
per call are the sums of the CUDA kernels' times in a torch.profiler trace
of 50 calls, divided by 50.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_route_probe.py
"""
import ctypes
import os
import subprocess
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import _build, matgen
from sparsemat_tpu_torch.kernels import _rowgroup as krg
from sparsemat_tpu_torch.kernels import route as kr

ITERS = 50
_SRC = os.path.join(_build.CSRC_DIR, "route.cu")
_KERNEL = "route_spmv_kernel"


def variants():
    """name → (the source text, the threads of a CTA)."""
    base = open(_SRC).read()
    bounds = ("__launch_bounds__(THREADS)\nroute_spmv_kernel",
              "__launch_bounds__(THREADS, 8)\nroute_spmv_kernel")
    staged = base[base.index("  for (int k = tid; k < n_e; k += THREADS) {\n"
                             "    __pipeline_memcpy_async(s_col"):
                  base.index("  // 3. this thread's items")]
    direct = """  __pipeline_commit();
  {
    int c[MAX_IPT];
    T v[MAX_IPT];
    T xv[MAX_IPT];
#pragma unroll
    for (int q = 0; q < MAX_IPT; ++q) {
      const int k = tid + q * THREADS;
      c[q] = k < n_e ? __ldg(cols + e0 + k) : 0;
      v[q] = k < n_e ? __ldg(vals + e0 + k) : T(0);
    }
#pragma unroll
    for (int q = 0; q < MAX_IPT; ++q) {
      const int k = tid + q * THREADS;
      xv[q] = k < n_e ? __ldg(x + c[q]) : T(0);
    }
#pragma unroll
    for (int q = 0; q < MAX_IPT; ++q) {
      const int k = tid + q * THREADS;
      if (k < n_e) s_val[k] = v[q] * xv[q];
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

"""
    for needle in (bounds[0], staged, "constexpr int THREADS = 256;"):
        if needle not in base:
            raise SystemExit(f"torch_route_probe.py: csrc/route.cu no longer holds {needle!r}")
    return {"base": (base, 256),
            "occ8": (base.replace(*bounds), 256),
            "t128": (base.replace("constexpr int THREADS = 256;", "constexpr int THREADS = 128;"),
                     128),
            "direct": (base.replace(staged, direct), 256),
            "direct+occ8": (base.replace(staged, direct).replace(*bounds), 256)}


def build(name, text):
    """The variant's library, built from a copy of the source and bound as
    ``kernels/route.py`` binds the kernel's."""
    vdir = os.path.join(_build.BUILD_DIR, "route_variants")
    os.makedirs(vdir, exist_ok=True)
    path = os.path.join(vdir, f"route_{name.replace('+', '_')}.cu")
    with open(path, "w") as f:
        f.write(text)
    so = _build.compile_shared(f"route_{name.replace('+', '_')}",
                               [_build.find_nvcc()] + _build.NVCC_FLAGS, [path])
    regs = subprocess.run([_build.find_nvcc()] + _build.NVCC_FLAGS[:-3] +
                          ["-c", "-Xptxas", "-v", "-o", os.devnull, path],
                          capture_output=True, text=True).stderr
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    for s in ("f32", "f64"):
        fn = getattr(lib, f"smt_route_spmv_{s}")
        fn.argtypes = [vp] * 6 + [ctypes.c_int64, ctypes.c_int] + [vp] * 5
        fn.restype = ctypes.c_int
    lib.smt_route_error_string.argtypes = [ctypes.c_int]
    lib.smt_route_error_string.restype = ctypes.c_char_p
    used = [ln.split("info    : ")[-1] for ln in regs.splitlines() if "Used" in ln]
    return lib, used


def dev_us(fn, key=None):
    """Device µs per call of ``fn``: the CUDA kernels (those whose name
    holds ``key``, or all) in a trace of ITERS calls, and their names."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and (key is None or key in e.key)]
    return sum(e.self_device_time_total for e in rows) / ITERS, sorted({e.key[:60] for e in rows})


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_route_probe.py needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    m = (matgen.circuit_scatter(seed=cs.SEED) * 2e-2).tocsr()
    m.sort_indices()
    csr = tsm.CSR.from_scipy(m, device=dev)
    rs = csr.to_route()
    plan = krg.plan_of(rs)
    x = torch.randn(m.shape[1], generator=cs.gen(dev), device=dev)
    vals, cols = plan.vals[0], plan.cols
    floors = {"copy cols": lambda: cols.clone(), "copy vals": lambda: vals.clone(),
              "gather x[cols]": lambda: torch.index_select(x, 0, cols),
              "vals * x[cols]": lambda: vals * torch.index_select(x, 0, cols)}
    for label, fn in floors.items():
        us, names = dev_us(fn)
        print(f"floor {label}: {us:.2f} us ({', '.join(names)})", flush=True)
    count = {"rowgroup_spmv": 0}
    us, _ = dev_us(lambda: krg.launch_spmv(plan, x, count, "rowgroup_spmv"), "rowgroup_spmv")
    print(f"row-group SpMV over the same plan: {us:.2f} us", flush=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        A = cs.torch_csr(csr)
    us, names = dev_us(lambda: torch.mv(A, x))
    print(f"torch.mv: {us:.2f} us ({', '.join(names)})", flush=True)
    del A

    lib0 = kr._kernels()
    threads0 = krg.MERGE_THREADS
    for name, (text, threads) in variants().items():
        lib, used = build(name, text)
        kr._lib, krg.MERGE_THREADS = lib, threads
        try:
            res = []
            for items in (512, 1024, 1536, 2048):
                split = krg.MergeSplit(plan, items)
                y = kr.launch(plan, split, x)
                ok = torch.equal(y, kr.route_spmv_walk(plan, split, x))
                us, _ = dev_us(lambda: kr.launch(plan, split, x), _KERNEL)
                res.append(f"{items} {us:.2f}{'' if ok else ' DIFFERS FROM ITS WALK'}")
            print(f"variant {name} ({'; '.join(used)}): " + "; ".join(res), flush=True)
        finally:
            kr._lib, krg.MERGE_THREADS = lib0, threads0


if __name__ == "__main__":
    main()
