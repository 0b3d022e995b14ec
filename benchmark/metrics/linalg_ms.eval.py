"""``linalg_ms.eval``: device milliseconds per evaluation of cuSOLVER's and
cuBLAS's kernels (the Cholesky, the triangular solves of K^-1, products),
by kernel name from the trace."""

from benchmark.common import readers
from benchmark.common.trace import device_seconds

# the port's hand-written kernels (ops/csrc), never counted as library time
OWN_KERNELS = ("ar1_cov_kernel", "syrk_grad_kernel", "posterior_kernel",
               "split_kernel", "diag_kinv_kernel")
# cuSOLVER's and cuBLAS's kernels, by the parts of their names
LINALG = ("potrf", "trsm", "trmm", "syrk", "herk", "gemm", "gemv", "trsv",
          "cusolver", "cublas", "magma", "xmma", "cutlass", "getrf",
          "potrs", "lauum", "trtri")


def read(run):
    if not run.summary:
        return None
    s, n = device_seconds(run.summary, *LINALG, exclude=OWN_KERNELS)
    t = readers.per(run, "evals", s)
    return None if not n or t is None else 1e3 * t
