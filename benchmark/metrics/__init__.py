"""Per-layer metrics: one reader per file, named as the metric, each with
read(records) -> value, a dict with "value" and notes, or None when the run
holds nothing for it."""
