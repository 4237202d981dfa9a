"""The executor's phase C per window: evidence assembly, the DM PLs on the
card, VariantCall (`stats["wall_profile"]["phase_c"]`)."""


def read(run):
    w = run.stats.get("wall_profile", {}).get("phase_c")
    return 1e3 * w["seconds"] / run.windows if w and run.windows else None
