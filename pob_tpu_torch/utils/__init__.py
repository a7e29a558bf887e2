"""Shared utilities: per-stage metrics, spans and launch counts (the
counterpart of pob_tpu/utils/metrics.py)."""
