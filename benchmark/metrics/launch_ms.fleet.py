"""``launch_ms.fleet``: host milliseconds per call of the program's span
``serve.launch`` in the traced window: one predict call of
``serve.BatchingQueue`` with its wait for the device lock, ending in the
host copy."""

from benchmark.common import spans


def read(run):
    return spans.host_ms(["serve.launch"], per="serve.launch")
