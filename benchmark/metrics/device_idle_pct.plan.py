"""The device's idle share of the traced window: 100 % less the share that
its kernels, copies and sets cover."""


def read(run):
    return run.events.idle_pct() if run.events else None
