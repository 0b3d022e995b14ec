"""Data pipeline: reference-schema CSV I/O, KF estimate generation, field
measurement synthesis, fidelity binning, the GP training harness, result
aggregation and the study sweep. Submodules import on first use."""
