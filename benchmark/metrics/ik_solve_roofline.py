"""`ik_solve_kernel`'s share of its roofline: the least time of its launches
(operations at the float32 peak or bytes at the HBM bandwidth, counted from
the configuration by `counts.py`) over their device time in the trace."""

from benchmark.metrics import counts


def read(run):
    return counts.roofline_pct(run, "ik_solve_kernel")
