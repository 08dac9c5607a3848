"""Share of one traced segment build in which no device operation ran."""

from portbench.trace import idle_pct


def read(record):
    return idle_pct(record)
