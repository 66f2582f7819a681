"""The whole call's share of the chip's float32 peak: the operations that
every kernel launch of the traced calls requires (`counts.py`, from the
configuration) over the traced window's length at 67 TFLOP/s."""

from benchmark.metrics import counts


def read(run):
    return counts.step_mfu_pct(run)
