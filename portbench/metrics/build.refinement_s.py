"""Seconds of per-path refinement per sealed segment, by the build's own
stage spans, mean over the window's builds."""


def read(record):
    st = record.values.get("build.stage_seconds")
    return sum(s["refinement"] for s in st) / len(st) if st else None
