"""The readers of the program's spans (`repro_torch.spans.totals()`): each
returns its number from a synthetic window's totals, and None, naming the
span, where the program has no such span or no spans at all (a program
without them, as before they were added)."""
from __future__ import annotations

import sys

import pytest

from perfbench.manifest import Manifest
from repro_torch import spans

TOTALS = {
    "train.optimizer": {"calls": 1, "host_ms": 3.0, "device_ms": 250.0},
    "train.accumulate": {"calls": 6, "host_ms": 2.0, "device_ms": 120.0},
    "model.layer.recompute": {"calls": 32, "host_ms": 9.0,
                              "device_ms": 200.0},
    "model.head": {"calls": 4, "host_ms": 1.0, "device_ms": 150.0},
    "model.loss": {"calls": 4, "host_ms": 1.0, "device_ms": 100.0},
    "model.head.backward": {"calls": 4, "host_ms": 1.0, "device_ms": 200.0},
    "serve.prefill": {"calls": 2, "host_ms": 30.0, "device_ms": 2000.0,
                      "tokens": 50000},
}
# each reader: the spans it reads, the run's info, and its value
READERS = {
    "optimizer_ms.train": (("train.optimizer",), {"steps": 2}, 125.0),
    "grad_accum_ms.train": (("train.accumulate",), {"steps": 1}, 120.0),
    "recompute_ms.train": (("model.layer.recompute",), {"steps": 1}, 200.0),
    "head_loss_ms.train": (("model.head", "model.loss",
                            "model.head.backward"), {"steps": 1}, 450.0),
    "head_ms.prefill": (("model.head", "serve.prefill"), {}, 3.0),
    "host_issue_pct.prefill": (("serve.prefill",), {}, 1.5),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader(name, monkeypatch, capsys):
    read = Manifest().module("metrics", name).read
    names, info, want = READERS[name]
    r = {"cell": None, "window": {}, "trace": None, "info": info}
    monkeypatch.setattr(spans, "totals", lambda: TOTALS)
    assert read(r) == pytest.approx(want)
    for gone in names:
        left = {k: v for k, v in TOTALS.items() if k != gone}
        monkeypatch.setattr(spans, "totals", lambda left=left: left)
        assert read(r) is None
        assert f"{name}: no span" in (err := capsys.readouterr().err) and \
            gone in err
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(r) is None
