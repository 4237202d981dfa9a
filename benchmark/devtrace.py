"""Reduce a torch.profiler trace of one job to device busy time, idle gaps
named by the host call they fall in, the device time of kernels launched
inside named host calls, and the card's largest operations.

Host calls are marked by `record_function` ranges whose names start with
"bench."; the harness wraps the program's calls from its own files. A
kernel belongs to a host call when the CPU event it is linked to (kineto's
external correlation: the innermost profiled range open at the launch)
starts inside that call's range on the same thread. A kernel launched from
the port's own ctypes libraries has no such op; its CUDA launch call on
the host (cudaLaunchKernel, cuLaunchKernel), matched by CUPTI correlation
id, gives its host time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PREFIX = "bench."


@dataclass
class Trace:
    window: tuple  # (start_ns, end_ns) of the job
    device: list  # (start_ns, end_ns, name, is_kernel, corr, linked_corr)
    ranges: list  # (start_ns, end_ns, name, thread) of "bench." ranges
    cpu_by_corr: dict = field(default_factory=dict)  # corr -> (start, thread)
    # CUDA API calls on the host (cuda*, cu*), by CUPTI correlation id
    runtime: dict = field(default_factory=dict)


def from_profiler(prof, job_range: str) -> Trace:
    """Collect the events of a finished `torch.profiler.profile`."""
    from torch.autograd import DeviceType

    device, ranges, cpu, runtime = [], [], {}, {}
    window = None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(PREFIX):
                continue  # kineto's GPU-side copy of a host range, not work
            kernel = not (name.startswith("Memcpy") or name.startswith("Memset"))
            device.append((s, s + d, name, kernel, e.correlation_id(),
                           e.linked_correlation_id()))
            continue
        if name.startswith("cu") and not name.startswith("cuda::"):
            runtime[e.correlation_id()] = (s, e.start_thread_id())
            continue
        cpu[e.correlation_id()] = (s, e.start_thread_id())
        if name == job_range:
            window = (s, s + d)
        elif name.startswith(PREFIX):
            ranges.append((s, s + d, name[len(PREFIX):], e.start_thread_id()))
    if window is None:
        raise RuntimeError(f"the trace holds no range {job_range!r}")
    return Trace(window, device, ranges, cpu, runtime)


def union(intervals, lo: int, hi: int) -> list:
    """Merged [start, end) intervals clipped to [lo, hi)."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(tr: Trace) -> float:
    lo, hi = tr.window
    return sum(e - s for s, e in union([(d[0], d[1]) for d in tr.device],
                                       lo, hi)) / 1e9


def window_seconds(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e9


def host_call_at(tr: Trace, t: int) -> str:
    """The innermost "bench." range open at t (any thread): "execute" is
    the executor outside the named calls, "cli" the entry outside the
    executor (reference and BAM header reads, the window list)."""
    best = None
    for s, e, name, _th in tr.ranges:
        if s <= t < e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "cli"


def idle_by_host_call(tr: Trace, top: int = 10) -> list:
    """Idle seconds of the card in the job's window, summed by the host
    call in which each gap's midpoint falls; the largest first."""
    lo, hi = tr.window
    busy = union([(d[0], d[1]) for d in tr.device], lo, hi)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    by: dict = {}
    for s, e in gaps:
        name = host_call_at(tr, (s + e) // 2)
        by[name] = by.get(name, 0.0) + (e - s) / 1e9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[5:] if name.startswith("void ") else name


def device_ops(tr: Trace, top: int = 10) -> list:
    """Device seconds by operation name in the job's window, largest first."""
    lo, hi = tr.window
    by: dict = {}
    for s, e, name, _k, _c, _l in tr.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            name = short_name(name)
            by[name] = by.get(name, 0.0) + d / 1e9
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


def launch_time(tr: Trace, corr: int, linked: int):
    """(host ns, thread) at which a device operation was launched: its
    runtime call's, else its linked CPU op's; None when neither is known."""
    return tr.runtime.get(corr) or tr.cpu_by_corr.get(linked)


def kernel_seconds_in(tr: Trace, calls: set) -> tuple[float, int]:
    """(device seconds, count) of the kernels launched inside the named
    host calls."""
    spans = {}
    for s, e, name, th in tr.ranges:
        if name in calls:
            spans.setdefault(th, []).append((s, e))
    total, n = 0.0, 0
    for s, e, _name, kernel, corr, linked in tr.device:
        at = launch_time(tr, corr, linked) if kernel else None
        if at and any(a <= at[0] < b for a, b in spans.get(at[1], ())):
            total += (e - s) / 1e9
            n += 1
    return total, n


def attribution(tr: Trace, calls: set) -> dict:
    """How the kernels were tied to their launches, for the run's log."""
    k = [d for d in tr.device if d[3]]
    by_rt = sum(1 for d in k if d[4] in tr.runtime)
    by_op = sum(1 for d in k if d[4] not in tr.runtime and d[5] in tr.cpu_by_corr)
    secs, n = kernel_seconds_in(tr, calls)
    return {"kernels": len(k), "kernel_s": sum(d[1] - d[0] for d in k) / 1e9,
            "by_runtime_call": by_rt, "by_linked_op": by_op,
            "in_calls": n, "in_calls_s": secs,
            "runtime_calls": len(tr.runtime)}
