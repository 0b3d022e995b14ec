"""``idle.<cell kind>``: the device's idle share of the cell's traced
window, percent: ``1 - busy / window`` (``common/trace``)."""

from benchmark.common import readers


def read(run):
    return readers.idle_pct(run)
