"""The executor's wall time waiting on phase A (BAM decode included), per
window: `stats["wall_profile"]["prep_wait"]`."""


def read(run):
    w = run.stats.get("wall_profile", {}).get("prep_wait")
    return 1e3 * w["seconds"] / run.windows if w and run.windows else None
