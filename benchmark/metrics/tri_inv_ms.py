"""``tri_inv_ms.<cell kind>`` (``.eval``, ``.unit``): device milliseconds
per call of the program's span ``linalg.tri_inv`` (the whole
lower-triangular inverse, ``ops/linalg.tri_inv_recursive``, not its
recursion) in the traced window: CUDA events around the call. None where
the program has no such span."""

from benchmark.common import spans


def read(run):
    return spans.device_ms("linalg.tri_inv")
