"""``b3_roofline``: B3's bound (``counts.b3_ops``/``b3_bytes``, the larger
time) over the device time per unit of ``posterior_kernel``
(``ops/csrc/posterior.cu``) in the trace."""

from benchmark.common import counts, readers
from benchmark.common.trace import device_seconds


def read(run):
    if not run.summary:
        return None
    s, n = device_seconds(run.summary, "posterior_kernel")
    t = readers.per(run, "units", s)
    N, M = run.config["N"], run.config["M"]
    return (counts.share_pct(counts.bound_s(counts.b3_ops(N, M),
                                            counts.b3_bytes(N, M)), t)
            if n and t else None)
