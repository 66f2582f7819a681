"""The 98th percentile of every plan's latency in the window, retries
included (linear interpolation between order statistics). cuRobo reports
its plans' mean and 98th percentile; the retried plans (4-6 % of them on the
suite, several times a first attempt's latency) make it."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 98)) * 1e3 if run.latencies else None
