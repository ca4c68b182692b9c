"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have (its state returned unchanged, half of its
batch left out, an answer altered where it is produced; for the learner,
Adam's state or the KL coefficient not handed on), and under the
control that puts the reference, or the program, at a lower precision or
with a guarantee broken, in the program's place."""

import pytest

import faults
from cpu_run import cpu_run

TRAIN = ("selfplay_cramped", "ppo_bc_phi_cramped")
CASES = ([(cell, f) for cell in TRAIN
          for f in ("unchanged", "half_batch", "altered", "adam_reset", "frozen_kl")]
         + [("random_play_pool64", f) for f in ("pool_unchanged", "pool_half_batch",
                                                "pool_altered")])


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_comes_out_not_correct(cell, fault):
    undo = faults.PLANT[fault]()
    try:
        assert not cpu_run(cell)["correct"]
    finally:
        undo()


def test_the_random_play_control_comes_out_not_correct():
    assert not cpu_run("random_play_pool64", control="no_reset")["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN)
def test_the_tf32_control_comes_out_not_correct_on_the_card(cell, card):
    assert not cpu_run(cell, control="tf32", device=card)["correct"]
