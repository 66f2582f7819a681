"""The 95th percentile of every tick's latency in the window: one
`MPCSolver.step` with the command on the host (linear interpolation between
order statistics)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3 if run.latencies else None
