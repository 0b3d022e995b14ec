"""``sweep_macs.sharded``: rank 0's multiply-adds, in units of 1e12, of the
identity sweeps that give its columns of K^-1, the program's counter
``par.sweep_macs`` (``parallel/chol``), per fully sharded evaluation
(``par.nlml``) in the traced window; None where the program has no such
counter."""

from benchmark.common import spans


def read(run):
    if "par.sweep_macs" not in (spans.snapshot() or {}).get("counters", {}):
        return None
    macs = spans.counted_per("par.sweep_macs", "par.nlml")
    return None if macs is None else macs / 1e12
