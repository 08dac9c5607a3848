"""Share of the roofline the distance kernels reached on the search calls
of the device trace (entry scores and the final per-path re-score)."""

from portbench.trace import roofline_pct


def read(record):
    return roofline_pct(record, "hybrid_distance")
