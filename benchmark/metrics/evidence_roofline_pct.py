"""The least time the card needs for the evidence work the job handed the
genotyper (roofline.py: int32 operations of both passes, or bytes over
HBM), over the device time of the kernels launched inside the genotyper's
evidence calls, in percent. Nothing to read without a card's trace."""

import devtrace
import roofline
from wrap import EVIDENCE_CALLS


def read(run):
    if run.trace is None or run.work is None or not run.clock_hz or not run.sms:
        return None
    dev_s, n = devtrace.kernel_seconds_in(run.trace, EVIDENCE_CALLS)
    if n == 0 or dev_s <= 0:
        return None
    least = roofline.min_seconds(run.work.ops, run.work.bytes, run.clock_hz,
                                 run.sms)
    return 100.0 * least / dev_s
