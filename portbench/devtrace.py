"""Reduce a ``torch.profiler`` trace of one profiled slice to what the
per-layer metrics read: the device's busy time, the device operations by
name, and its idle gaps by what the host was doing in them.

``reduce_slice`` is plain arithmetic over (name, start µs, end µs) tuples,
so the CPU tests check it on made-up events; ``trace_events`` takes them out
of a profiler run.
"""

TOP = 10
#: what the host was doing in a gap that no host op of the trace covers
BETWEEN_OPS = "python between torch ops"


def _merge(intervals):
    """Union of (start, end) intervals, sorted, as disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _innermost(host_ops, times):
    """For each time (sorted), the name of the innermost host op that
    contains it, or ``BETWEEN_OPS``.  Host ops nest, as one thread's do."""
    ops = sorted(host_ops, key=lambda o: (o[1], -o[2]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(ops) and ops[k][1] <= t:
            while stack and stack[-1][2] <= ops[k][1]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else BETWEEN_OPS)
    return out


def reduce_slice(events, window, host_ops=()):
    """Busy and idle time of the device over ``window`` (start µs, end µs).

    ``events``: (name, start_us, end_us) of every device operation (kernels,
    copies, memsets); the part of each inside the window counts.  A gap is
    a stretch of the window in which no operation runs; it is charged to
    the innermost of ``host_ops`` (name, start_us, end_us) that runs at its
    middle: what the host was doing while the device waited.
    """
    w0, w1 = window
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in events if e > w0 and s < w1]
    busy = _merge([(s, e) for _, s, e in inside])
    busy_us = sum(e - s for s, e in busy)
    by_name = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    holes, edge = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            holes.append((edge, s))
        edge = max(edge, e)
    gaps = {}
    for (s, e), who in zip(holes, _innermost(host_ops, [(s + e) / 2 for s, e in holes])):
        gaps[who] = gaps.get(who, 0.0) + (e - s)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "idle_pct": 100.0 * (1.0 - busy_us / (w1 - w0)) if w1 > w0 else None,
        "count": len(inside),
        "device_s": sum(e - s for _, s, e in inside) * 1e-6,
        "device_ops": [[n[:160], t * 1e-6] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[n[:160], t * 1e-6] for n, t in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def trace_events(prof, span):
    """(device events, window, host ops) of the ``record_function(span)``
    range of ``prof``: every device operation of the trace as (name, start
    µs, end µs), the span's (start, end), and every host op (torch ops and
    CUDA runtime calls, the span itself left out) as (name, start, end)."""
    from torch.autograd import DeviceType

    evs = list(prof.events())
    ranges = [e.time_range for e in evs
              if e.name == span and e.device_type == DeviceType.CPU]
    if not ranges:
        raise RuntimeError(f"the profiler recorded no host range {span!r}")
    window = (ranges[-1].start, ranges[-1].end)
    device, host = [], []
    for e in evs:
        if e.name == span:
            continue
        t = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not (e.is_user_annotation
                    or "annotation" in (getattr(e, "activity_type", "") or "")):
                device.append(t)
        elif e.device_type == DeviceType.CPU and not e.is_async:
            host.append(t)
    return device, window, host
