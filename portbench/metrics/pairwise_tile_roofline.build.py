"""Share of the roofline the pair-tile kernel reached over the prune
chunks of one traced segment build."""

from portbench.trace import roofline_pct


def read(record):
    return roofline_pct(record, "pairwise_tile")
