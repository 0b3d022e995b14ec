"""Benchmark of mfgp_tpu_torch (see run.py)."""
