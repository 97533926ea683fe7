"""The device-memory rate a CUDA card reaches for the DIA SpMV's traffic,
the ceiling its bound (bytes over the data sheet's 3.35 TB/s) does not
see.  Kernels of ``scripts/torch_stream_probe.cu``, a persistent grid of
16-byte loads with U vectors of every stream in flight a thread:

- a plain copy (one stream read, one written) at working sets of 8 MB to
  1 GB (bytes read plus bytes written), beside ``Tensor.copy_``;
- the DIA's streams: n_d + 1 = 6 streams read and one written, at the two
  timed operands' working sets, 117.4 MB (2048² rows) and 469.8 MB (2^24
  rows);
- the DIA SpMV kernel itself (``kernels/dia.py`` ``dia_spmv`` and
  ``dia_spmv_dot``) on those operands: the 2048² Poisson band of
  ``chip_smoke.py`` phase 4 and the 2^24-row band of phase 7, per call
  (CUDA events) and on the device (profiler), as a share of 3.35 TB/s and
  of the streams' best rate at the same working set.

Each time is the best of three CUDA-event timings of back-to-back launches
after a warm-up; a rate is the bytes moved over it.  Working sets above the
50 MB L2 stream device memory; the smaller ones measure L2.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_stream_probe.py
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

MB = 1e6
COPY_SETS_MB = (8, 16, 32, 64, 128, 256, 512, 1024)
DIA_ROWS = {"2048²": 2048 * 2048, "2^24": 1 << 24}
N_D = 5
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_stream_probe.cu")


def load():
    lib = ctypes.CDLL(_build.compile_shared(
        "stream_probe", [_build.find_nvcc()] + _build.NVCC_FLAGS, [_SRC]))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.probe_streams.argtypes = [i32, i32, vp, i64, vp, i32, vp]
    lib.probe_streams_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.probe_threads.restype = i32
    lib.probe_error_string.argtypes = [i32]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def best_ms(fn, total_ms=20.0):
    """Best of three CUDA-event timings of back-to-back calls of ``fn``,
    each over about ``total_ms``."""
    fn()
    torch.cuda.synchronize()
    reps = max(3, int(total_ms / max(cs.cuda_ms(fn, 3, warmup=1), 1e-3)))
    return min(cs.cuda_ms(fn, reps, warmup=1) for _ in range(3))


def streams_ms(lib, ns, u, src, n, dst, stream):
    """ms of one launch of ns streams of n values, U vectors in flight."""
    per = ctypes.c_int(0)
    rc = lib.probe_streams_per_sm(ns, u, ctypes.byref(per))
    if rc != 0:
        raise RuntimeError(lib.probe_error_string(rc).decode())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads = lib.probe_threads()
    grid = max(1, min(sms * per.value, -(-n // (4 * threads * u))))

    def launch():
        rc = lib.probe_streams(ns, u, src.data_ptr(), n, dst.data_ptr(), grid, stream)
        if rc != 0:
            raise RuntimeError(lib.probe_error_string(rc).decode())

    return best_ms(launch), grid


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_stream_probe: torch finds no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    lib = load()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []

    for ws in COPY_SETS_MB:
        n = int(ws * MB / 8) // 4 * 4
        src = torch.randn(n, device=dev)
        dst = torch.empty_like(src)
        moved = 8 * n
        row = {"probe": "copy", "working_set_mb": moved / MB}
        for u in (1, 4):
            ms, grid = streams_ms(lib, 1, u, src, n, dst, stream)
            row[f"U{u}_gbs"] = moved / ms / 1e6
            row["grid"] = grid
        row["copy__gbs"] = moved / best_ms(lambda: dst.copy_(src)) / 1e6
        rows.append(row)
        print(json.dumps(row), flush=True)
        del src, dst

    ceiling = {}
    for label, n in DIA_ROWS.items():
        src = torch.randn((N_D + 1) * n, device=dev)
        dst = torch.empty(n, device=dev)
        moved = (N_D + 2) * n * 4
        row = {"probe": f"dia streams {label}", "streams_read": N_D + 1,
               "working_set_mb": moved / MB}
        for u in (1, 2, 4):
            ms, grid = streams_ms(lib, N_D + 1, u, src, n, dst, stream)
            row[f"U{u}_gbs"] = moved / ms / 1e6
            row[f"U{u}_ms"] = ms
            row["grid"] = grid
        ceiling[label] = max(row[f"U{u}_gbs"] for u in (1, 2, 4))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del src, dst

    g = cs.gen(dev)
    _, poisson, _ = cs.assemble_poisson(2048, dev)
    x = torch.randn(poisson.shape[0], generator=g, device=dev)
    band = cs.averaging_dia(1 << 24, 1 << 24, (-4096, -1, 0, 1, 4096), torch.float32, g)
    xb = torch.randn(1 << 24, generator=g, device=dev)
    cases = [("dia_spmv 2048²", "2048²", lambda: kd.dia_spmv(poisson, x), "dia_spmv"),
             ("dia_spmv_dot 2048²", "2048²", lambda: kd.dia_spmv_dot(poisson, x),
              "dia_spmv_dot"),
             ("dia_spmv 2^24", "2^24", lambda: kd.dia_spmv(band, xb), "dia_spmv")]
    for name, label, fn, counter in cases:
        moved = (N_D + 2) * DIA_ROWS[label] * 4
        ms = best_ms(fn)
        dev_ms = cs.device_us(fn, 50, "dia_spmv_kernel", lambda c=counter: kd.LAUNCHES[c]) / 1e3
        row = {"probe": name, "ms": ms, "device_ms": dev_ms, "gbs": moved / ms / 1e6,
               "device_gbs": moved / dev_ms / 1e6,
               "share_of_3350": moved / dev_ms / 1e6 / 3350,
               "share_of_ceiling": moved / dev_ms / 1e6 / ceiling[label],
               "ceiling_gbs": ceiling[label]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": smi, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
