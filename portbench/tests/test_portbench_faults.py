"""The comparison that decides ``correct`` catches each fault a cell can
have, planted under the timed path of a rehearsal (faults.py)."""

import json

import pytest

from portbench import faults, harness

TRAIN = "r18v2-f32-train-b256"
INFER = "r18v2-f32-infer-private-b1024"


def _run(cell, capsys, seed=3000000007):
    code = harness.run(["--workload", cell, "--seed", str(seed),
                        "--seconds", "0.3"], 0.0, rehearsal=True)
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_is_correct(capsys):
    assert _run(INFER, capsys)["correct"] is True


def test_sound_training_reads_far_under_a_fault(capsys):
    """The training limits are set at the cell's batch on the card; at the
    rehearsal's batch of 4 rounding moves a step more, so a sound rehearsal
    is held only to read far under a frozen step."""
    sound = _run(TRAIN, capsys)["checks"]
    with faults.plant("frozen_state"):
        frozen = _run(TRAIN, capsys)["checks"]
    for name, check in sound.items():
        assert check["value"] * 10 < frozen[name]["value"], name


@pytest.mark.parametrize("cell, fault",
                         [(TRAIN, f) for f in faults.TRAIN]
                         + [(INFER, f) for f in faults.INFER])
def test_fault_is_caught(cell, fault, capsys):
    with faults.plant(fault):
        line = _run(cell, capsys)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_plant_restores_the_program():
    import deepipr_tpu_torch.train.epoch as epoch
    from deepipr_tpu_torch.serve import Predictor

    before = (epoch.make_train_step, Predictor.predict)
    for name in faults.TRAIN + faults.INFER:
        with faults.plant(name):
            assert (epoch.make_train_step, Predictor.predict) != before
    assert (epoch.make_train_step, Predictor.predict) == before
