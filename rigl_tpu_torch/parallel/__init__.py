"""Parallel layouts of the port: so far the single-device half of expert
parallelism (packed_ep.py: expert-stacked packed storage, top-1 routing,
per-expert drop/grow)."""
