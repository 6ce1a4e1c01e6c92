"""Benchmark helpers."""

from .harness import bench_packed_train_step, make_bench_dataset

__all__ = ["bench_packed_train_step", "make_bench_dataset"]
