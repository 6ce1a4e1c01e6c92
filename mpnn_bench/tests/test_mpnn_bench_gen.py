"""The benchmark's generator makes what the program's generator makes."""

import numpy as np

from mpnn_bench import gen


def test_records_equal_make_bench_dataset():
    from ionic_mpnn_torch.benchmarks.harness import make_bench_dataset

    want, vocab = make_bench_dataset(512, seed=0)
    got, (av, bv) = gen.make_bench_dataset(512, seed=0)
    assert got == want
    assert av == vocab.atom_vocab and bv == vocab.bond_vocab


def test_library_equals_the_programs():
    from ionic_mpnn_torch.data.synthetic import SCREEN_ANIONS, enumerate_cations

    assert gen.enumerate_cations(2688) == enumerate_cations(2688)
    assert gen.SCREEN_ANIONS == SCREEN_ANIONS


def test_train_traffic_keeps_the_set_and_reorders_it():
    mix = {"records": 64, "batch": 16, "batches": 4, "composition_seed": 0,
           "temperature": [280.0, 360.0], "targets": {"log_eta": [1.5, 0.5]}}
    a, _, chunks = gen.train_traffic(mix, 2**31 + 7, "log_eta")
    b, _, _ = gen.train_traffic(mix, 2**31 + 7, "log_eta")
    c, _, _ = gen.train_traffic(mix, 11, "log_eta")
    assert a == b and a != c
    assert [len(ch) for ch in chunks] == [16] * 4
    size = lambda recs: sorted(r["cation"]["num_atoms"] * 100 + r["anion"]["num_atoms"]
                               for r in recs)
    assert size(a) == size(c)
    assert all(280 <= r["T"] <= 360 for r in a)


def test_screen_library_and_temperatures():
    mix = {"cations": 2688, "refused": ["[O-]Cl(=O)(=O)=O"], "temperature": [273.15, 393.15],
           "temperatures": 156}
    cations, anions, parsed, graphs, vocab = gen.screen_library(mix)
    assert len(cations) == 2688 and len(parsed) == 24 and len(anions) == 25
    t1 = gen.screen_temperatures(mix, 5)
    t2 = gen.screen_temperatures(mix, 6)
    assert t1.dtype == np.float32 and sorted(t1) == sorted(t2) and list(t1) != list(t2)
