"""Metrics and debug tooling (rt_tpu/utils)."""
