"""The comparison that decides ``correct``, driven on the CPU at a tiny
size through the same drivers, reference and limits as a run on the card
(the harness's look for a card skipped): the program's plain CPU path
passes; the control (the reference in TF32 in the program's place) and
each fault a cell can have, planted in the program, fail."""

import pytest

from mpnn_bench import calibrate, check, run

from .tiny import CPU, SEED, cell

TRAIN = ["visc-train-b2048", "mp-train-b2048", "mp-train-b32"]
ALL = TRAIN + ["visc-screen-grid"]


def correct(c, rec):
    return run.result(c, rec, False, CPU)["correct"]


@pytest.mark.parametrize("workload", ALL)
def test_program_agrees_with_the_reference(workload):
    c = cell(workload)
    rec = run.drive(c, SEED, 0.2, False, CPU, 0.0)
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert correct(c, rec), rec["numbers"]


@pytest.mark.parametrize("workload", ALL)
def test_control_fails(workload):
    c = cell(workload)
    ok, checks = check.judge(run.control(c, SEED, CPU), c["limits"])
    assert not ok, checks


@pytest.mark.parametrize("workload", TRAIN)
def test_step_that_leaves_its_state_unchanged_fails(workload, monkeypatch):
    from ionic_mpnn_torch.training import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    c = cell(workload)
    rec = run.drive(c, SEED, 0.2, False, CPU, 0.0)
    assert rec["numbers"]["change_gap"] >= 0.99
    assert not correct(c, rec)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out_fails(workload, monkeypatch):
    from ionic_mpnn_torch.training import loop

    monkeypatch.setattr(loop, "data_loss", calibrate.half_batch(loop.data_loss))
    c = cell(workload)
    assert not correct(c, run.drive(c, SEED, 0.2, False, CPU, 0.0))


@pytest.mark.parametrize("alter", ["value", "candidate"])
def test_screening_answer_altered_fails(alter, monkeypatch):
    from ionic_mpnn_torch.inference import ScreeningEngine

    real = ScreeningEngine.screen_grid

    def altered(self, *a, **kw):
        rep = real(self, *a, **kw)
        r = rep.results
        if alter == "value":
            r[0].prediction += 0.01
        else:  # the best candidate swapped for the worst of the returned temperature's
            r[0].cation, r[-1].cation = r[-1].cation, r[0].cation
        return rep

    monkeypatch.setattr(ScreeningEngine, "screen_grid", altered)
    c = cell("visc-screen-grid")
    assert not correct(c, run.drive(c, SEED, 0.2, False, CPU, 0.0))
