"""What ``correct`` is decided by comes out false where it has to, at CPU size: the control
(the reference at 4 bits in the program's place) fails a cell's limits, and a run whose
timed path is broken underneath reads ``correct`` false, once for each fault the cell can
have: a training step that leaves its state unchanged, a step over half of its batch (the
mean taken over the rest; in every step, and in the steps after the first alone, which on
the card are the replayed ones), a served token altered where it is produced. (No cell spans
chips, so no exchange between chips can be left out.) On the card the same readings come
from ``python3 -m benchmark.run --control`` at the cells' own sizes."""

from pathlib import Path

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import CELLS, make_root

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, **kw):
    return run_cell(root, cell, SEED, 0.5, False, "cpu", log=lambda msg: None, **kw)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-chat", "tiny-batch"])
def test_program_correct_and_control_fails(root, cell):
    result = run(root, cell, control=True)
    assert result["correct"], result["checks"]
    limits = CELLS[cell]["limits"]
    control = result["extra"]["control"]
    assert any(control[k] > limits[k] for k in control), control


def test_half_batch_reads_high_in_the_reference(root):
    extra = run(root, "tiny-train", control=True)["extra"]
    limits = CELLS["tiny-train"]["limits"]
    assert extra["half_batch"]["grad_gap"] > limits["grad_gap"]
    assert extra["half_batch_step2"]["grad2_gap"] > limits["grad2_gap"]


def test_state_left_unchanged(root, monkeypatch):
    from llama_x_tpu_torch.train import optim

    monkeypatch.setattr(optim.AdamW, "step", lambda self, grads, norm=None, apply=None: None)
    result = run(root, "tiny-train")
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(root, monkeypatch):
    from llama_x_tpu_torch.train import trainer

    real = trainer.step_graph.run

    def half(state, name, static, batch, micro, update, *, eager):
        # the second microbatch dropped: the mean is taken over the first alone
        return real(state, name, static, {k: v[:1] for k, v in batch.items()}, micro, update, eager=eager)

    monkeypatch.setattr(trainer.step_graph, "run", half)
    result = run(root, "tiny-train")
    assert not result["correct"], result["checks"]


def test_half_of_the_batch_left_out_after_the_first_step(root, monkeypatch):
    from llama_x_tpu_torch.train import trainer

    real = trainer.step_graph.run
    calls = []

    def half_after_first(state, name, static, batch, micro, update, *, eager):
        # as the card's fault in the graph replays (packed_sft.FAULTS): the first step sound,
        # each later one given its first microbatch in place of every microbatch
        calls.append(name)
        if len(calls) > 1:
            batch = {k: v[:1].expand(len(v), *v.shape[1:]) for k, v in batch.items()}
        return real(state, name, static, batch, micro, update, eager=eager)

    monkeypatch.setattr(trainer.step_graph, "run", half_after_first)
    result = run(root, "tiny-train")
    assert not result["correct"], result["checks"]
    checks = result["checks"]
    assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
    assert checks["grad2_gap"]["value"] > checks["grad2_gap"]["limit"]


def test_the_card_fault_is_taken_out_after_its_run(root):
    # on the CPU the step is never replayed, so the fault changes nothing here; its numbers
    # are read on the card (``benchmark.run --fault replay_half``)
    from llama_x_tpu_torch.train import step_graph

    real = step_graph.Runner.replay
    result = run(root, "tiny-train", fault="replay_half")
    assert step_graph.Runner.replay is real
    assert result["correct"], result["checks"]


def test_served_token_altered(root, monkeypatch):
    from llama_x_tpu_torch.serve import continuous

    real = continuous.sample_logits_rows

    def shifted(logits, *args, **kw):
        return torch.remainder(real(logits, *args, **kw) + 1, logits.shape[-1])

    monkeypatch.setattr(continuous, "sample_logits_rows", shifted)
    result = run(root, "tiny-chat")
    assert not result["correct"], result["checks"]
