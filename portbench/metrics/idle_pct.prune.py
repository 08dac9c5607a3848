"""Share of the RNG-IP pruning stage of one traced segment build in which
no device operation ran."""

from portbench.spans import idle_pct_in


def read(record):
    return idle_pct_in(record, "build.prune")
