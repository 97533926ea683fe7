"""What the card is and what it reaches: its name, clocks and power limit
from ``nvidia-smi``, and its measured device-memory copy rate, the ceiling
that the data sheet's 3.35 TB/s in ``roofline.py`` does not see.

The copy rate takes the arithmetic of ``scripts/torch_stream_probe.py``: a
copy moves its bytes once read and once written, and its time is the best
of three CUDA-event timings of back-to-back copies after a warm-up.  The
working set (two arrays of ``COPY_MB`` each) is over four times the 50 MB L2,
so it streams device memory.
"""

import subprocess

COPY_MB = 256
SMI_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"


def smi():
    """nvidia-smi's reading of the first card as {field: text}, or {} where
    the tool is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    line = out.strip().splitlines()[0] if out.strip() else ""
    return dict(zip(SMI_FIELDS.split(","), (v.strip() for v in line.split(","))))


def _cuda_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copy_rate_bytes_per_s(device):
    """The card's device-to-device copy rate: bytes read plus bytes written
    over the best of three timings of ``Tensor.copy_``."""
    import torch

    n = COPY_MB * 10**6 // 4
    src = torch.ones(n, device=device)
    dst = torch.empty_like(src)
    ms = min(_cuda_ms(lambda: dst.copy_(src), 20) for _ in range(3))
    moved = 2 * 4 * n
    del src, dst
    return moved / (ms * 1e-3)
