"""``chol_ms.eval``: device milliseconds per call of the program's span
``mfgp.chol`` (the Cholesky and its log-determinant, B4) in the traced
window: CUDA events around the stage (``models/mfgp._nlml_vg_core``)."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("mfgp.chol")
