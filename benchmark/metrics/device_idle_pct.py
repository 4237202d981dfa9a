"""100 - the union of kernel and copy intervals on the card over the job's
wall time, in percent, from torch.profiler over the whole traced job."""

import devtrace


def read(run):
    if run.trace is None or not any(True for _ in run.trace.device):
        return None
    w = devtrace.window_seconds(run.trace)
    return 100.0 * (1.0 - devtrace.busy_seconds(run.trace) / w) if w > 0 else None
