"""Times the DIA SpMV kernel (``kernels/dia.py`` ``dia_spmv`` and
``dia_spmv_dot``) of one tree of this repository on a CUDA card, so that
two trees can be compared in one machine, in turns:

    python3 scripts/torch_dia_compare.py --tag parent --root path/to/parent
    python3 scripts/torch_dia_compare.py --tag change --loop
    python3 scripts/torch_dia_compare.py --tag change2 --loop
    python3 scripts/torch_dia_compare.py --tag parent2 --root path/to/parent

``--root`` names the tree whose ``sparsemat_tpu_torch`` is imported (by
default this one); the operands are made here, from a seed, with nothing
but ``tsm.DIA``, so any tree's package takes them.  Operands (f32 unless
said), each with random values on the band:

- ``row1 2^24``: the SpMV on the 2^24-row band (-4096, -1, 0, 1, 4096);
- ``tri 2^24``: the SpMV on the 2^24-row tridiagonal band;
- ``row1 2048²``, ``row2 2048²`` (f32, f64): the SpMV, and the SpMV with
  its dot, on the 2048² Poisson offsets (-2048, -1, 0, 1, 2048);
- ``row2 512²``: the SpMV with its dot on CG 512²'s offsets;
- ``27pt 128³``: the SpMV and the SpMV with its dot on the 27-point
  stencil of a 128³ grid.

For each: three measured calls (CUDA events over back-to-back calls,
wrapper included), the device µs of the SpMV kernel and of every kernel
one call launches (profiler), and a hash of y and the dot's bits, so two
trees' results can be held to be bitwise equal.  ``--loop`` (a tree whose
``kernels/dia.py`` has ``SPECIALISED``) also times, in turns with the
compiled diagonal count (compiled, loop, loop, compiled), the same operand
on the kernel's runtime-count loop.  One JSON line per operand.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import sparsemat_tpu_torch as tsm
    from sparsemat_tpu_torch.kernels import dia as kd

    if not torch.cuda.is_available():
        raise SystemExit("torch_dia_compare: torch finds no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)

    def band(n, offs, dtype=torch.float32):
        data = torch.rand(len(offs), n, generator=g, device=dev) - 0.5
        i = torch.arange(n, device=dev)
        for d, o in enumerate(offs):
            data[d][(i + o < 0) | (i + o >= n)] = 0
        x = torch.randn(n, generator=g, device=dev)
        A = tsm.DIA(data=data.to(dtype).contiguous(), offsets=tuple(offs), shape=(n, n))
        return A, x.to(dtype)

    def ms3(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iters)
        return out

    def device_us(fn, iters=50):
        """(µs of the SpMV kernel, µs of every kernel) per call."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        spmv = sum(e.self_device_time_total for e in rows if "dia_spmv_kernel" in e.key)
        return spmv / iters, sum(e.self_device_time_total for e in rows) / iters

    def digest(out):
        h = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    n2, n5 = 2048 * 2048, 512 * 512
    poisson = (-2048, -1, 0, 1, 2048)
    stencil = sorted({a * 128 * 128 + b * 128 + c for a in (-1, 0, 1) for b in (-1, 0, 1)
                      for c in (-1, 0, 1)})
    cases = [
        ("row1 2^24", band(1 << 24, (-4096, -1, 0, 1, 4096)), False, 20),
        ("tri 2^24", band(1 << 24, (-1, 0, 1)), False, 20),
        ("row1 2048²", band(n2, poisson), False, 50),
        ("row2 2048² f32", band(n2, poisson), True, 50),
        ("row2 2048² f64", band(n2, poisson, torch.float64), True, 50),
        ("row2 512²", band(n5, (-512, -1, 0, 1, 512)), True, 200),
        ("27pt 128³ spmv", band(128 ** 3, stencil), False, 50),
        ("27pt 128³ dot", band(128 ** 3, stencil), True, 50),
    ]
    for label, (A, x), dot, iters in cases:
        fn = (lambda A=A, x=x: kd.dia_spmv_dot(A, x)) if dot else (lambda A=A, x=x: kd.dia_spmv(A, x))
        row = {"tag": args.tag, "case": label, "n": A.shape[0], "n_d": len(A.offsets),
               "dtype": str(x.dtype), "hash": digest(fn())}
        forms = {"kernel": None}
        if args.loop and kd.dia_spmv_plan(A, x.dtype, dev).n_d:
            # the same operand's plans with no compiled count: the loop
            spec = dict(A._spmv_plans)
            kept, kd.SPECIALISED = kd.SPECIALISED, ()
            object.__setattr__(A, "_spmv_plans", {})
            row["loop_hash"] = digest(fn())
            kd.SPECIALISED = kept
            forms = {"kernel": spec, "loop": dict(A._spmv_plans)}
        order = list(forms) + list(forms)[::-1]
        for form in order:
            if forms[form] is not None:
                object.__setattr__(A, "_spmv_plans", forms[form])
            runs = ms3(fn, iters)
            spmv_us, all_us = device_us(fn)
            row.setdefault(f"{form}_runs_ms", []).extend(runs)
            row.setdefault(f"{form}_device_us", []).append(spmv_us)
            row.setdefault(f"{form}_device_all_us", []).append(all_us)
        print(json.dumps(row), flush=True)
        del A, x
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
