"""The window's length over the `IKSolver.solve_pose` calls it completed
(each one batch, ending with the answers on the host)."""


def read(run):
    return run.window_s / run.calls * 1e3 if run.calls else None
