"""``kinv_ms.eval``: device milliseconds per call of the program's span
``mfgp.kinv`` (alpha and K^-1 by the blocked triangular solves, B5) in the
traced window: CUDA events around the stage
(``models/mfgp._nlml_vg_core``)."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("mfgp.kinv")
