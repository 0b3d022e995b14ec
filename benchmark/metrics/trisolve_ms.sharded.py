"""``trisolve_ms.sharded``: rank 0's device milliseconds of the program's
span ``par.trisolve`` (the two identity sweeps that give its columns of
K^-1, their panel broadcasts included) per fully sharded evaluation
(``par.nlml``) in the traced window."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("par.trisolve", per="par.nlml")
