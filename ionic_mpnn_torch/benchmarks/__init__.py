"""Benchmark helpers."""

from .harness import BenchResult, bench_packed_train_step, make_bench_dataset, time_train_step

__all__ = ["BenchResult", "bench_packed_train_step", "make_bench_dataset", "time_train_step"]
