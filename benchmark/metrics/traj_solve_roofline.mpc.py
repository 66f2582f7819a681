"""`traj_solve_kernel`'s share of its roofline at the mpc cell's shapes: the
least time of its launches (counted from the configuration and the calls'
problems and attempts by `counts.py`) over their device time in the trace."""

from benchmark.metrics import counts


def read(run):
    return counts.roofline_pct(run, "traj_solve_kernel")
