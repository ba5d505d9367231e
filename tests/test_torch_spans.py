"""The port's spans (`repro_torch.spans`) on the CPU: a tiny dense model
(the reduced qwen3-8b, remat by layer) trained a step in 2 microbatches
and served a prefill. Without a profiler nothing is recorded and no hook
is registered; with one the outputs keep their bits, each span has its
calls (and prefill its ``tokens``), each is a ``user_annotation`` of the
profiler's own trace, and a span of work on the CPU keeps the host's clock
whatever the process has done with CUDA. The path over a process group
(ZeRO-1) runs the same spans."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, spans
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ShapeSpec
from repro_torch.serve.serve_step import make_prefill
from repro_torch.train import AdamW, init_state, make_train_step
from repro_torch.train.data import make_batch

MB = 2
PREFILL = ("serve.prefill", "serve.inputs", "model.embed", "model.layer",
           "model.head")


def _cfg():
    return dataclasses.replace(configs.get_reduced("qwen3-8b"), remat="block")


def _train_calls(cfg) -> dict:
    """Each span's calls in a step of `MB` microbatches."""
    L = cfg.n_layers
    return {"train.forward": MB, "train.backward": MB,
            "train.accumulate": MB + 2, "train.optimizer": 1,
            "model.embed": MB, "model.layer": L * MB,
            "model.layer.recompute": L * MB, "model.head": MB,
            "model.loss": MB, "model.head.backward": MB}


def _batch(cfg, rows: int) -> dict:
    return make_batch(cfg, ShapeSpec("t", 16, rows, "train"), 0, device="cpu")


class _Recording(AdamW):
    """AdamW that keeps the gradients it was given."""

    def update(self, grads, state, params, **kw):
        self.seen = {n: g.clone() for n, g in grads.items()}
        return super().update(grads, state, params, **kw)


def _train(cfg, profiled: bool):
    """One step from seed 0: (loss, gradients, updated parameters), the
    spans' totals, and the trace's events where profiled."""
    opt = _Recording(lr=1e-3)
    state = init_state(cfg, 0, opt, device="cpu")
    step = make_train_step(cfg, opt, MB)
    batch = _batch(cfg, 2 * MB)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, met = step(state, batch)
    else:
        state, met = step(state, batch)
    out = (met["loss"], opt.seen,
           {n: p.detach().clone() for n, p in
            state["params"].named_parameters()})
    return out, spans.totals(), prof if profiled else None


def _prefill(cfg, profiled: bool):
    params = init_params(cfg, 0, "cpu")
    tokens = _batch(cfg, 3)["tokens"]
    prefill = make_prefill(cfg, "cpu")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            logits = prefill(params, {"tokens": tokens})
    else:
        logits = prefill(params, {"tokens": tokens})
    return logits, spans.totals(), prof if profiled else None


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("run", [_train, _prefill], ids=["train", "prefill"])
def test_outputs_keep_their_bits_and_nothing_is_kept_without_profiler(run):
    """Without a profiler the store gains nothing; under a CPU profile the
    train step's loss, gradients and updated parameters, and the prefill's
    logits, are bitwise those of the run without it."""
    cfg = _cfg()
    before = spans.totals()
    off, after, _ = run(cfg, False)
    assert after == before
    on, got, _ = run(cfg, True)
    assert got and _equal(on, off)


def test_train_spans_calls_and_counts(monkeypatch):
    """Each span's calls; the clock of the work's device, the host's here,
    also in a process where CUDA is initialised (as on a card's host,
    after other tests ran there)."""
    cfg = _cfg()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _, got, _ = _train(cfg, True)
    assert {k: v["calls"] for k, v in got.items()} == _train_calls(cfg)
    for v in got.values():
        assert set(v) == {"calls", "host_ms", "device_ms"}
        assert v["host_ms"] > 0 and v["device_ms"] == v["host_ms"]


def test_prefill_spans_calls_and_counts():
    cfg = _cfg()
    _, got, _ = _prefill(cfg, True)
    assert set(got) == set(PREFILL)
    assert got["serve.prefill"]["tokens"] == 3 * 16
    assert got["serve.prefill"]["calls"] == got["serve.inputs"]["calls"] == 1
    assert got["model.layer"]["calls"] == cfg.n_layers
    assert got["model.head"]["calls"] == 1


def _annotations(prof, tmp_path) -> list:
    tmp_path.mkdir()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation"]


def test_spans_are_annotations_of_the_profilers_trace(tmp_path):
    """Each span is a ``user_annotation`` event of the exported trace, as
    often as it was called, and each recomputation lies inside a
    backward."""
    cfg = _cfg()
    _, got, prof = _train(cfg, True)
    ann = _annotations(prof, tmp_path / "train")
    for name, v in got.items():
        assert sum(e["name"] == name for e in ann) == v["calls"], name
    back = [(e["ts"], e["ts"] + e["dur"]) for e in ann
            if e["name"] == "train.backward"]
    for e in ann:
        if e["name"] == "model.layer.recompute":
            assert any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                       for lo, hi in back)
    _, got, prof = _prefill(cfg, True)
    ann = _annotations(prof, tmp_path / "prefill")
    assert {e["name"] for e in ann} == set(PREFILL)


def test_off_is_one_shared_context_and_no_hook():
    """With no profiler, every span is the same no-op context and the
    loss carries no hook; under one, the loss carries the hook that opens
    ``model.head.backward``."""
    assert spans.span("a", "cpu") is spans.span(
        "b", torch.device("cuda"), in_backward="c", n=1)
    cfg = _cfg()
    params = init_params(cfg, 0, "cpu").requires_grad_(True)
    batch = _batch(cfg, 2)
    loss = loss_fn(params, batch, cfg)
    assert not loss._backward_hooks
    with profile(activities=[ProfilerActivity.CPU]):
        loss = loss_fn(params, batch, cfg)
    assert len(loss._backward_hooks) == 1
    assert set(spans.totals()) == {"model.embed", "model.layer",
                                   "model.head", "model.loss"}


def test_each_profiler_session_starts_afresh():
    """A window's totals are read after it closes and stay readable; the
    next window's first span starts the store again."""
    for names in (("one", "two"), ("three",)):
        with profile(activities=[ProfilerActivity.CPU]):
            for name in names:
                with spans.span(name, "cpu", k=2):
                    pass
        got = spans.totals()
        assert sorted(got) == sorted(names) and spans.totals() == got
        assert all(v["calls"] == 1 and v["k"] == 2 for v in got.values())


def test_spans_over_a_process_group(tmp_path):
    """The ZeRO-1 step over two gloo ranks: the same bits with the
    profiler on, and the same spans and calls on each rank."""
    from _torch_dist import run_world

    ranks = run_world(2, {"train_spans": {"arch": "qwen3-8b",
                                          "microbatches": MB}}, tmp_path)
    cfg = _cfg()
    for r in ranks:
        got = r["train_spans"]
        assert got["same_bits"]
        assert got["calls"] == _train_calls(cfg)
