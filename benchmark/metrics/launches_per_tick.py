"""Device kernels, copies and sets launched inside each `MPCSolver.step`
call's span, averaged over the traced calls."""


def read(run):
    return run.events.launches_per_call() if run.events else None
