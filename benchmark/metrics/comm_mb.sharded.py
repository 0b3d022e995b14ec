"""``comm_mb.sharded``: megabytes (1e6 bytes) of rank 0's collectives, the
program's counter ``par.collective_bytes`` (``parallel/mesh``), per fully
sharded evaluation (``par.nlml``) in the traced window."""

from benchmark.common import spans


def read(run):
    b = spans.counted_per("par.collective_bytes", "par.nlml")
    return None if b is None else b / 1e6
