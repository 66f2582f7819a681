"""The window's length over the `MotionPlanner.plan_pose` calls it completed
(B = 1, each ending with the trajectory on the host)."""


def read(run):
    return run.window_s / run.calls * 1e3 if run.calls else None
