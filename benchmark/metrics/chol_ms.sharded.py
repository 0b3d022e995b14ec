"""``chol_ms.sharded``: rank 0's device milliseconds of the program's span
``par.chol`` (the distributed Cholesky, ``parallel/chol._chol_cols_body``,
its panel broadcasts included) per fully sharded evaluation (``par.nlml``)
in the traced window."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("par.chol", per="par.nlml")
