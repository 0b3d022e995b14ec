"""The import guard: no module of JAX, or of the JAX package the program
was ported from, may be loaded in a run. Names are compared by their
top-level part (before the first dot), whole: ``mfgp_tpu_torch`` is the
program and passes; ``mfgp_tpu`` and ``mfgp_tpu.models`` do not."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mfgp_tpu"})


def forbidden(module_names) -> list[str]:
    """The forbidden top-level names among ``module_names``, sorted."""
    return sorted({n.split(".", 1)[0] for n in module_names}
                  & FORBIDDEN)
