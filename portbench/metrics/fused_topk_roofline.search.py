"""Share of the roofline the fused top-k kernels reached on the search
calls of the device trace."""

from portbench.trace import roofline_pct


def read(record):
    return roofline_pct(record, "fused_topk")
