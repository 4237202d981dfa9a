"""The executor's `device` phase per window: a host clock around phase B's
submit and finish (pool uploads, pass-1 launches, the gate and crop, pass 2
and the copies back), not device time."""


def read(run):
    w = run.stats.get("wall_profile", {}).get("device")
    return 1e3 * w["seconds"] / run.windows if w and run.windows else None
