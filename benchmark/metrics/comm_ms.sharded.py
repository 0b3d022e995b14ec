"""``comm_ms.sharded``: rank 0's device milliseconds of the program's span
``par.comm`` (every collective of ``parallel/mesh``: from the stream's
arrival at it to the collective's end, so the wait for the slowest rank
and the exchange that no work hides) per fully sharded evaluation
(``par.nlml``) in the traced window."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("par.comm", per="par.nlml")
