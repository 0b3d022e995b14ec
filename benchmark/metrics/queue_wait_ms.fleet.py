"""``queue_wait_ms.fleet``: the mean of the program's observation
``serve.queue_wait`` in the traced window: a request's wait in
``serve.BatchingQueue`` from ``submit`` to the start of the predict call
that serves it (the batching window and the launches ahead of it)."""

from benchmark.common import spans


def read(run):
    return spans.observed_ms("serve.queue_wait")
