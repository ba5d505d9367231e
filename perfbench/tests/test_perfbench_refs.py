"""The plain reference against the port at the port's reduced
configuration (`repro_torch.configs.get_reduced`), on the CPU, where the
port runs its kernels' plain versions: prefill logits, alone and of a
batch of prompts against each prompt alone, and training steps."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import weights
from perfbench.refs import common as ref
from perfbench.tests.small import model_of

CPU = torch.device("cpu")


def _port(arch: str):
    from repro_torch import configs

    return configs.get_reduced(arch)


@pytest.mark.parametrize("B", [1, 3])
def test_prefill_logits_equal_the_port(B):
    from repro_torch.models import forward
    from repro_torch.models.zoo import LM

    m, cfg = model_of("qwen3-8b"), _port("qwen3-8b")
    leaves = weights.draw(m, 3, CPU)
    params = weights.bind(LM(cfg, torch.device("meta")), leaves)
    tok = torch.randint(0, m["vocab_size"], (B, 40), generator=torch.Generator(
        ).manual_seed(0), dtype=torch.int32)
    with torch.no_grad():
        got = forward(params, {"tokens": tok}, cfg)
        for r in range(B):
            want = ref.logits(leaves, ref.hidden(leaves, tok[r][None], m,
                                                 ref.Arith()), ref.Arith())[0]
            torch.testing.assert_close(got[r], want, rtol=1e-4, atol=1e-4)


def test_training_steps_equal_the_port():
    from repro_torch.models.zoo import LM
    from repro_torch.train import AdamW, cosine_schedule, make_train_step

    m, cfg = model_of("qwen3-8b"), _port("qwen3-8b")
    cfg = dataclasses.replace(cfg, remat="none")
    hp = {"lr": 3e-3, "warmup": 2, "schedule_steps": 10, "b1": 0.9,
          "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}
    gen = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(2):
        seq = torch.randint(0, m["vocab_size"], (2, 33), generator=gen,
                            dtype=torch.int32)
        batches.append({"tokens": seq[:, :-1], "targets": seq[:, 1:]})
    params = weights.bind(LM(cfg, torch.device("meta")),
                          weights.draw(m, 5, CPU))
    params.requires_grad_(True)
    opt = AdamW(lr=cosine_schedule(hp["lr"], hp["warmup"],
                                   hp["schedule_steps"]),
                b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                weight_decay=hp["weight_decay"], clip_norm=hp["clip_norm"])
    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(cfg, opt, 2)
    losses = []
    for i, b in enumerate(batches):
        state, out = step(state, b)
        losses.append(float(out["loss"]))
        if i == 0:
            g1 = {n: float(torch.linalg.vector_norm(t)) / (1 - hp["b1"])
                  for n, t in state["opt"]["m"].items()}
    want = ref.train(weights.draw(m, 5, CPU), batches, m, hp, ref.Arith())
    p0 = weights.draw(m, 5, CPU)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    for n, p in state["params"].named_parameters():
        assert g1[n] == pytest.approx(want["g1"][n], rel=1e-4, abs=1e-7), n
        d = float(torch.linalg.vector_norm(p.detach() - p0[n]))
        assert d == pytest.approx(want["delta"][n], rel=1e-3, abs=1e-7), n


def test_the_control_rounds_to_fp8():
    a = ref.Arith("fp8")
    x = torch.linspace(-3, 3, 101)
    q = a.q(x)
    assert not torch.equal(q, x)
    assert torch.equal(a.q(q), q)
    assert float((q - x).abs().max()) <= 3 / 16
    assert torch.equal(ref.Arith().q(x), x)
