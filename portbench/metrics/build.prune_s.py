"""Seconds of RNG-IP pruning per sealed segment, by the build's own stage
clock, mean over the window's builds."""


def read(record):
    st = record.values.get("build.stage_seconds")
    return sum(s["prune"] for s in st) / len(st) if st else None
