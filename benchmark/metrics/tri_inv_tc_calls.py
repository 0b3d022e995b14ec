"""``tri_inv_tc_calls.<cell kind>`` (``.eval``, ``.unit``): the program's
counter ``linalg.tri_inv_tc`` (one per triangular inverse whose products
ran on the 3xTF32 tensor-core engine, ``ops/csrc/tri_gemm.cu``) per call of
the span ``linalg.tri_inv`` in the traced window; 0 where every inverse
took the strips, None where the program has no such span."""

from benchmark.common import spans


def read(run):
    return spans.counted_per("linalg.tri_inv_tc", per="linalg.tri_inv")
