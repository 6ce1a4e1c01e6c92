"""The port's data preparation against the JAX package's: the raw-file
generator, the parsers, the graph conversion, the vocab and the id data,
the screening library, and ``cli.prepare_data`` feeding
``cli.train_viscosity`` on the CPU.

Everything here is exact: the generator makes the same stdlib ``random``
calls with the same format strings (the files are compared byte for
byte), and the rest is the same Python on the same inputs (records,
reports, vocab and id data compared with ``==``).
"""

import json
import pickle

import pytest
import torch

import ionic_mpnn_tpu.data.encode as jencode
import ionic_mpnn_tpu.data.featurize as jfeaturize
import ionic_mpnn_tpu.data.parse as jparse
import ionic_mpnn_tpu.data.synthetic as jsynthetic
import ionic_mpnn_tpu.data.vocab as jvocab
import ionic_mpnn_torch.data.encode as tencode
import ionic_mpnn_torch.data.featurize as tfeaturize
import ionic_mpnn_torch.data.parse as tparse
import ionic_mpnn_torch.data.synthetic as tsynthetic
import ionic_mpnn_torch.data.vocab as tvocab
from ionic_mpnn_torch.cli import prepare_data, train_viscosity
from ionic_mpnn_torch.data.reference_io import load_id_data_npz, load_pickle

RAW = ("ca", "viscosity", "mp")
SIZES = dict(n_viscosity=300, n_mp=120)  # the conftest fixture's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CLI test trains on the CPU; with the suite's parallel workers,
    each op's thread pool would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("label_mode", ["vft", "hard"])
@pytest.mark.parametrize("seed", [0, 1])
def test_raw_files_are_byte_equal(tmp_path, seed, label_mode):
    want = jsynthetic.generate_ionic_liquid_raw(tmp_path / "jax", seed=seed,
                                                label_mode=label_mode, **SIZES)
    got = tsynthetic.generate_ionic_liquid_raw(tmp_path / "port", seed=seed,
                                               label_mode=label_mode, **SIZES)
    assert set(got) == set(want) == set(RAW)
    for key in RAW:
        assert got[key].name == want[key].name
        assert got[key].read_bytes() == want[key].read_bytes(), key


def test_generator_noise_and_label_mode_match_jax(tmp_path):
    kw = dict(n_viscosity=40, n_mp=20, seed=5, noise=0.3, label_mode="hard")
    want = jsynthetic.generate_ionic_liquid_raw(tmp_path / "jax", **kw)
    got = tsynthetic.generate_ionic_liquid_raw(tmp_path / "port", **kw)
    for key in RAW:
        assert got[key].read_bytes() == want[key].read_bytes(), key
    for mod in (jsynthetic, tsynthetic):
        with pytest.raises(ValueError, match="unknown label_mode"):
            mod.generate_ionic_liquid_raw(tmp_path / "x", label_mode="soft")


def test_parse_and_convert_match_jax(synthetic_raw, tmp_path):
    cations, anions = tparse.load_ca_smiles(synthetic_raw["ca"])
    assert (cations, anions) == jparse.load_ca_smiles(synthetic_raw["ca"])
    for task, fn in (("viscosity", "parse_viscosity"), ("mp", "parse_melting_point")):
        records = getattr(tparse, fn)(synthetic_raw[task], cations, anions)
        assert records == getattr(jparse, fn)(synthetic_raw[task], cations, anions)
        # a record whose SMILES does not parse is skipped with its error
        records = records[:20] + [dict(records[0], pair_id="C999_A001",
                                       cation_smiles="((bad")]
        got, got_report = tparse.convert_records_to_graphs(records, task)
        want, want_report = jparse.convert_records_to_graphs(records, task)
        assert got == want
        assert got_report.to_json() == want_report.to_json()
        assert got_report.summary() == want_report.summary()
        assert json.loads(got_report.to_json())["skipped"][0]["pair_id"] == "C999_A001"
    # malformed, unmatched and header lines are skipped without a word
    vis = tmp_path / "VISCOSITY.txt"
    vis.write_text("pair_id pressure T log_viscosity\nC001_A001 101.3 300.0 1.5\n"
                   "C001_A001 101.3 warm 1.5\nC001 101.3 300.0 1.5\nC001_A999 1 300 1\n"
                   "short line\n\nC002_A003 101.3 310.5 0.25\n")
    got = tparse.parse_viscosity(vis, cations, anions)
    assert got == jparse.parse_viscosity(vis, cations, anions)
    assert [r["pair_id"] for r in got] == ["C001_A001", "C002_A003"]
    for mod in (tparse, jparse):
        for fn in ("parse_viscosity", "parse_melting_point"):
            with pytest.raises(FileNotFoundError, match="Raw data file not found"):
                getattr(mod, fn)(tmp_path / "nope.txt", cations, anions)
        with pytest.raises(FileNotFoundError, match="Raw data file not found"):
            mod.load_ca_smiles(tmp_path / "nope.smi")


def test_vocab_and_id_data_match_jax(synthetic_raw):
    cations, anions = tparse.load_ca_smiles(synthetic_raw["ca"])
    vis, _ = tparse.convert_records_to_graphs(
        tparse.parse_viscosity(synthetic_raw["viscosity"], cations, anions), "viscosity")
    mp, _ = tparse.convert_records_to_graphs(
        tparse.parse_melting_point(synthetic_raw["mp"], cations, anions), "mp")
    got = tvocab.build_vocab([vis, mp])
    want = jvocab.build_vocab([vis, mp])
    assert got.to_dict() == want.to_dict()
    for graphs in (vis, mp):
        ids, report = tencode.encode_dataset(graphs, got)
        j_ids, j_report = jencode.encode_dataset(graphs, want)
        assert ids == j_ids
        assert report.summary() == j_report.summary()


def test_screening_library_and_families_match_jax():
    assert tsynthetic.SCREEN_ANIONS == jsynthetic.SCREEN_ANIONS
    assert tsynthetic._CHAIN_TERMINALS == jsynthetic._CHAIN_TERMINALS
    for n in (1, 7, 300, 2000):
        assert tsynthetic.enumerate_cations(n) == jsynthetic.enumerate_cations(n)
    smiles = [fn(n1, n2) if kind == "im" else fn(n1)
              for kind, fn in tsynthetic.CATION_TEMPLATES for n1 in (1, 4) for n2 in (0, 1)]
    smiles += tsynthetic.enumerate_cations(400) + ["[Cl-]", "CCO"]
    families = [tsynthetic.cation_family_from_smiles(s) for s in smiles]
    assert families == [jsynthetic.cation_family_from_smiles(s) for s in smiles]
    assert set(families) == {"imidazolium", "pyridinium", "ammonium", "phosphonium",
                             "pyrrolidinium", "other"}
    for kind in ("im", "py", "am", "ph", "pyr"):
        assert (tsynthetic._cation_descriptor(kind, 4, 1)
                == jsynthetic._cation_descriptor(kind, 4, 1))


def test_featurize_backends():
    assert tfeaturize.have_rdkit() is False
    smi = "CCCCn1cc[n+](c1)C"
    want = jfeaturize.smiles_to_graph(smi, backend="python")
    assert tfeaturize.smiles_to_graph(smi) == want
    assert tfeaturize.smiles_to_graph(smi, backend="auto") == want
    assert tfeaturize.smiles_to_graph(smi, backend="python") == want
    with pytest.raises(RuntimeError, match="RDKit backend requested but rdkit is not"):
        tfeaturize.smiles_to_graph(smi, backend="rdkit")
    with pytest.raises(ValueError, match="Invalid SMILES"):
        tfeaturize.smiles_to_graph("((bad")


def test_prepare_data_cli_then_train_viscosity_cli(tmp_path, capsys):
    """``cli.prepare_data --synthetic`` writes what the JAX pipeline makes of
    the same raw files; ``cli.train_viscosity --device cpu`` trains on it."""
    data = tmp_path / "data"
    assert prepare_data.main(["--data-dir", str(data), "--synthetic", "--n-viscosity",
                              "80", "--n-mp", "30", "--seed", "2", "--pairs-csv"]) == 0
    cations, anions = jparse.load_ca_smiles(data / "CA.smi")
    vis, _ = jparse.convert_records_to_graphs(
        jparse.parse_viscosity(data / "VISCOSITY.txt", cations, anions), "viscosity")
    mp, _ = jparse.convert_records_to_graphs(
        jparse.parse_melting_point(data / "MP.txt", cations, anions), "mp")
    vocab = jvocab.build_vocab([vis, mp])
    assert load_pickle(data / "viscosity_graph_data.pkl") == vis
    assert load_pickle(data / "mp_graph_data.pkl") == mp
    with open(data / "vocab.pkl", "rb") as f:
        assert pickle.load(f) == vocab.to_dict()
    for name, graphs in (("viscosity", vis), ("mp", mp)):
        ids, _ = jencode.encode_dataset(graphs, vocab)
        assert load_pickle(data / f"{name}_id_data.pkl") == ids
        assert len(load_id_data_npz(data / f"{name}_id_data.npz")) == len(ids)
    assert (data / "pairs.csv").read_text().splitlines()[0] == "cation,anion,T,log_eta,mp"
    assert len((data / "pairs.csv").read_text().splitlines()) == 81

    out = tmp_path / "results"
    assert train_viscosity.main([
        "--device", "cpu", "--data", str(data / "viscosity_id_data.pkl"),
        "--vocab", str(data / "vocab.pkl"), "--out-dir", str(out), "--epochs", "1",
        "--num-steps", "1", "--batch-size", "16"]) == 0
    printed = capsys.readouterr().out
    assert "wrote id data" in printed and "Test: R2=" in printed
    assert (out / "history_viscosity.pkl").exists()
    assert any((out / "checkpoints").glob("step_*/meta.json"))
