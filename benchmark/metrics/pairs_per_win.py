"""Read-haplotype pairs the genotyper ran pass 1 over, per window: an exact
count of K1's work (`stats["pass2"]["total"]`)."""


def read(run):
    p = run.stats.get("pass2", {}).get("total")
    return p / run.windows if p and run.windows else None
