"""Shared utilities: per-stage metrics and the timing harness (the
counterparts of pob_tpu/utils/{metrics,profiling}.py)."""
