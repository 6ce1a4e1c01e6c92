"""Benchmark helpers."""

from .harness import make_bench_dataset

__all__ = ["make_bench_dataset"]
