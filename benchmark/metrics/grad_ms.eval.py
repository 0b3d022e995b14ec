"""``grad_ms.eval``: device milliseconds per call of the program's span
``mfgp.grad`` (the gradient's K^-1 contractions, ``grad_from_kinv``) in the
traced window: CUDA events around the stage
(``models/mfgp._nlml_vg_core``)."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("mfgp.grad")
