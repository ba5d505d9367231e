"""A run drives the rest of its path with the timed path broken underneath
(the look for a card skipped: the small cells on the CPU), and `correct`
comes out false: a training step that returns its state unchanged (from
the first step, and from the first step after the warm-up), one that
leaves half of the batch out (the mean over the rest), and a served
answer altered where it is produced. The sound path, and the control
(the reference in fp8 put in the program's place), are read beside
them."""
from __future__ import annotations

import pytest
import torch

from perfbench import calibrate
from perfbench import run as bench
from perfbench.tests.small import CELLS, MIXES, make_root

TRAIN, PREFILL = "tiny-dense.train-tiny", "tiny-dense.prefill-tiny"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell):
    return bench.run(cell, 11, 1.0, False, root=root, device="cpu")


@pytest.mark.parametrize("cell", [TRAIN, PREFILL])
def test_sound_path_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", [TRAIN, PREFILL])
def test_control_fails_the_limits(root, cell):
    got = calibrate.readings(cell, 12, 1.0, True, root=root, device="cpu")
    limits = CELLS[cell]
    assert any(got["control"][k] > v for k, v in limits.items()), got


@pytest.mark.parametrize("sound_calls", [0, MIXES["train-tiny"]["warmup_steps"]])
def test_state_left_unchanged_is_not_correct(root, monkeypatch, sound_calls):
    """The step leaves the state as it was, from its first call, or only
    once the warm-up's steps have run soundly."""
    import repro_torch.train as train

    real = train.make_train_step

    def frozen(cfg, opt, microbatches=1):
        from repro_torch.models import loss_fn

        sound = real(cfg, opt, microbatches)
        calls = []

        def step(state, batch):
            calls.append(1)
            if len(calls) <= sound_calls:
                return sound(state, batch)
            with torch.no_grad():
                loss = loss_fn(state["params"], batch, cfg)
            return state, {"loss": loss}
        return step

    monkeypatch.setattr(train, "make_train_step", frozen)
    out = _run(root, TRAIN)
    assert not out["correct"]
    assert out["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_left_out_is_not_correct(root, monkeypatch):
    import repro_torch.train as train

    real = train.make_train_step

    def half(cfg, opt, microbatches=1):
        step = real(cfg, opt, microbatches)

        def halved(state, batch):
            n = batch["tokens"].shape[0] // 2
            return step(state, {k: torch.cat([v[:n], v[:n]])
                                for k, v in batch.items()})
        return halved

    monkeypatch.setattr(train, "make_train_step", half)
    assert not _run(root, TRAIN)["correct"]


def test_altered_prefill_answer_is_not_correct(root, monkeypatch):
    import repro_torch.serve.serve_step as ss

    real = ss.make_prefill

    def altered(cfg, *a, **k):
        prefill = real(cfg, *a, **k)

        def bad(params, batch):
            logits = prefill(params, batch).clone()
            for row in logits[:, 0]:    # each prompt's first position
                row[(int(row.argmax()) + 1) % row.shape[0]] = row.max() + 1
            return logits
        return bad

    monkeypatch.setattr(ss, "make_prefill", altered)
    assert not _run(root, PREFILL)["correct"]
