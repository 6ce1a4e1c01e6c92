"""Benchmark helpers."""

from .harness import (BenchResult, bench_dense_reference, bench_packed_train_step,
                      bench_paired_epoch_step, make_bench_dataset, time_train_step)

__all__ = ["BenchResult", "bench_dense_reference", "bench_packed_train_step",
           "bench_paired_epoch_step", "make_bench_dataset", "time_train_step"]
