"""Share of the per-path refinement stage of one traced segment build in
which no device operation ran."""

from portbench.spans import idle_pct_in


def read(record):
    return idle_pct_in(record, "build.refinement")
