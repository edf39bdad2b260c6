"""moe_route's share of its roofline in the traced sub-window."""
from perfbench.metrics._share import roofline_share


def read(run):
    return roofline_share(run, "moe_route")
