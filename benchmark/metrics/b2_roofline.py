"""``b2_roofline``: B2's bound (``counts.b2_ops``/``b2_bytes``, the larger
time) over the device time per unit of ``syrk_grad_kernel``
(``ops/csrc/syrk_grad.cu``) in the trace."""

from benchmark.common import counts, readers
from benchmark.common.trace import device_seconds


def read(run):
    if not run.summary:
        return None
    s, n = device_seconds(run.summary, "syrk_grad_kernel")
    t = readers.per(run, "units", s)
    N = run.config["N"]
    return (counts.share_pct(counts.bound_s(counts.b2_ops(N),
                                            counts.b2_bytes(N)), t)
            if n and t else None)
