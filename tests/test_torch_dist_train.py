"""Data- and expert-parallel training across ranks against the reference.

The port runs over gloo process groups of 1, 2 and 4 CPU processes
(`_torch_dist.run_world`, one launch a world size); the reference runs its
distributed step on 4 fake host devices in one subprocess
(`_torch_dist.run_jax`), as `tests/test_sharding_dist.py` does.

- Dense: one ZeRO-1 step of float32 reduced qwen3-8b (global batch 4) on
  data 2 and data 4, within 1e-4 of the port's one-device step and of the
  reference's step on a fake (data 4, model 1) mesh: the loss and every
  parameter after the step (the reference's own bound,
  `tests/test_sharding_dist.py:48-72`), and the global gradient norm
  within 1e-5 relative. One AdamW step from zero moments moves every
  entry by about the learning rate whatever the gradient's scale, so
  only the norm sees a gradient averaged wrongly over dp or counted
  twice in the clip.
- MoE: the reduced kimi-k2 step with 8 expert slots (perturbed apart) on
  4 ranks through `moe_sharded`, against the reference's on the same fake
  mesh, to the same 1e-4 and the norm to 1e-5 relative.
- Replicated state: on 3 ranks, where ZeRO-1 leaves every moment whole,
  the dense step (a global batch of 6) against the one-device step.
- Checkpoints: a checkpoint written by a world of 2 restores on worlds of
  1, 2 and 4; the next step's loss equals the uninterrupted run's bitwise
  on the same world, and within 1e-6 relative on another.
- Launcher: `launch.train` with ``--device cpu`` over a world of 2
  resumes bitwise, over the data axis and over the model axis
  (``--data 1 --model 2``).
- Specs: `batch_pspecs`, `cache_pspecs`, the shapes and dtypes of
  `input_specs`/`decode_input_specs` and `skip_reason` equal the
  reference's for every config and shape on both production meshes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist import run_jax, run_world
from repro_torch import configs
from repro_torch.convert import train_state_from_numpy
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    batch_pspecs,
    build_cell,
    cache_pspecs,
    decode_input_specs,
    input_specs,
    skip_reason,
    train_collectives,
)
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.parallel import parallel_ctx
from repro_torch.train import AdamW, make_train_step

TOL = 1e-4
GNORM_RTOL = 1e-5
RESTORE_RTOL = 1e-6

JAX_SCRIPT = r"""
import dataclasses, pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh, Mesh, PartitionSpec as P
from repro import configs
from repro.launch.specs import (batch_pspecs, cache_pspecs,
                                decode_input_specs, input_specs, skip_reason)
from repro.models.config import SHAPES
from repro.parallel import parallel_ctx
from repro.parallel.sharding import default_rules
from repro.train import AdamW, init_state, make_train_step

np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("data", "model"))
rules = default_rules(mesh)
out = {}


def batch_of(cfg, seed, B=4, T=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def perturb(tree, seed):
    rng = np.random.default_rng(seed)
    def f(path, w):
        keys = [str(getattr(k, "key", k)) for k in path]
        if "moe" in keys and "shared" not in keys and keys[-1] in (
                "w_gate", "w_up", "w_down"):
            return (w + 0.5 * np.abs(w).mean()
                    * rng.standard_normal(w.shape)).astype(w.dtype)
        return w
    return jax.tree_util.tree_map_with_path(f, tree)


def dist_step(cfg, state, batch):
    step = make_train_step(cfg, AdamW(lr=1e-3, zero1=True), 1)
    def wrapped(s, b):
        with parallel_ctx(mesh, rules):
            return step(s, b)
    with parallel_ctx(mesh, rules):
        s2, m2 = jax.jit(wrapped)(jax.tree_util.tree_map(jnp.asarray, state),
                                  jax.tree_util.tree_map(jnp.asarray, batch))
    return {"loss": float(m2["loss"]), "grad_norm": float(m2["grad_norm"]),
            "params": np_tree(s2["params"])}


dense = dataclasses.replace(configs.get_reduced("qwen3-8b"), dtype="float32")
state = np_tree(init_state(dense, jax.random.PRNGKey(0),
                           AdamW(lr=1e-3, zero1=True)))
batch = batch_of(dense, 0)
out["dense"] = {"state": state, "batch": batch,
                "dist": dist_step(dense, state, batch)}

moe = dataclasses.replace(configs.get_reduced("kimi-k2-1t-a32b"),
                          dtype="float32", n_expert_slots=8)
state = np_tree(init_state(moe, jax.random.PRNGKey(1),
                           AdamW(lr=1e-3, zero1=True)))
state["params"] = perturb(state["params"], 1)
batch = batch_of(moe, 1)
out["moe"] = {"state": state, "batch": batch,
              "dist": dist_step(moe, state, batch)}

# checkpoints: a dropless kimi-k2 (experts resharded from 2 to 1 and 4)
ck = dataclasses.replace(moe, capacity_factor=8.0)
state = np_tree(init_state(ck, jax.random.PRNGKey(2),
                           AdamW(lr=1e-3, zero1=True)))
state["params"] = perturb(state["params"], 2)
out["ckpt"] = {"state": state, "batches": [batch_of(ck, 2), batch_of(ck, 3)]}

# specs on both production meshes, every config and shape
def norm(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)

specs = {}
for multi in (False, True):
    shape_, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else \
        ((16, 16), ("data", "model"))
    amesh = AbstractMesh(shape_, axes)
    for arch in configs.all_arch_ids():
        cfg = configs.get(arch)
        with parallel_ctx(amesh) as ctx:
            for name, shape in SHAPES.items():
                rec = {"skip": skip_reason(cfg, shape)}
                if shape.kind == "decode":
                    cache, tok = decode_input_specs(cfg, shape)
                    cs = cache_pspecs(cache, ctx, cfg)
                    rec["cache"] = {k: (tuple(v.shape), str(v.dtype),
                                        norm(cs[k])) for k, v in cache.items()}
                    rec["tokens"] = (tuple(tok.shape), str(tok.dtype),
                                     norm(batch_pspecs(tok, ctx)))
                else:
                    b = input_specs(cfg, shape)
                    bs = batch_pspecs(b, ctx)
                    rec["batch"] = {k: (tuple(v.shape), str(v.dtype),
                                        norm(bs[k])) for k, v in b.items()}
                specs[(multi, arch, name)] = rec
out["specs"] = specs

with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def tmp_mod(tmp_path_factory):
    return tmp_path_factory.mktemp("dist_train")


@pytest.fixture(scope="module")
def reference(tmp_mod):
    return run_jax(JAX_SCRIPT, tmp_mod / "jax")


def _case(ref, arch, **replace):
    return {"arch": arch, "state": ref["state"], "batch": ref["batch"],
            "replace": replace}


@pytest.fixture(scope="module")
def worlds(reference, tmp_mod):
    """The port's runs: world 2 (the steps, the checkpoint it writes, the
    launcher), world 4 (the steps, the restore), world 1 (the restore),
    world 3 (the dense step where ZeRO-1 cuts no parameter)."""
    ck = dict(reference["ckpt"], arch="kimi-k2-1t-a32b",
              replace={"n_expert_slots": 8, "capacity_factor": 8.0},
              dir=str(tmp_mod / "ckpt"))
    dense = _case(reference["dense"], "qwen3-8b")
    moe = _case(reference["moe"], "kimi-k2-1t-a32b", n_expert_slots=8)
    argv = ["--arch", "qwen3-8b", "--reduced", "--batch", "4", "--seq", "16",
            "--ckpt-every", "2", "--seed", "0"]
    out = {}
    out[2] = run_world(2, {
        "train_step": {"dense": dense},
        "checkpoint_write": ck,
        "launcher": {"argv": argv, "dir": str(tmp_mod / "launch")},
        "sharding_helpers": {}},
        tmp_mod / "w2")
    out[4] = run_world(4, {"train_step": {"dense": dense, "moe": moe},
                           "checkpoint_restore": ck}, tmp_mod / "w4")
    out[1] = run_world(1, {"checkpoint_restore": ck}, tmp_mod / "w1")
    out[3] = run_world(3, {"train_step": {"dense": dict(
        dense, batch=_batch6(reference["dense"]))}}, tmp_mod / "w3")
    return out


def _batch6(ref):
    """A global batch of 6 rows (2 a rank on 3 ranks) of the dense case's
    width and vocabulary."""
    B, T = ref["batch"]["tokens"].shape
    V = configs.get_reduced("qwen3-8b").vocab_size
    toks = np.random.default_rng(6).integers(0, V, (6, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _one_device(ref, batch=None):
    """The port's one-device step from the same state and batch (`batch`,
    else the case's)."""
    cfg = dataclasses.replace(configs.get_reduced("qwen3-8b"), dtype="float32")
    state = train_state_from_numpy(ref["state"], cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in (batch or ref["batch"]).items()}
    state, met = make_train_step(cfg, AdamW(lr=1e-3, zero1=True), 1)(state,
                                                                        batch)
    return float(met["loss"]), float(met["grad_norm"]), {
        n: p.detach().numpy() for n, p in state["params"].named_parameters()}


def _by_port_name(tree, names):
    """Leaf `blocks.3.attn.w_q` of the port is layer 3 of the reference's
    stacked `blocks.attn.w_q`."""
    out = {}
    for name in names:
        parts = name.split(".")
        layer = None
        node = tree
        for part in parts:
            if part.isdigit():
                layer = int(part)
                continue
            node = node[part]
        out[name] = np.asarray(node if layer is None else node[layer])
    return out


def _assert_close(got: dict, want: dict, tol):
    assert set(got) == set(want)
    worst = max(float(np.max(np.abs(got[n] - want[n]))) for n in got)
    assert worst < tol, worst


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("against", ["one_device", "reference"])
def test_dense_step_matches(worlds, reference, world, against):
    got = worlds[world][0]["train_step"]["dense"]
    if against == "one_device":
        loss, gnorm, params = _one_device(reference["dense"])
    else:
        loss = reference["dense"]["dist"]["loss"]
        gnorm = reference["dense"]["dist"]["grad_norm"]
        params = _by_port_name(reference["dense"]["dist"]["params"],
                               list(got["params"]))
    assert abs(got["loss"] - loss) < TOL
    np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=GNORM_RTOL,
                               atol=0)
    _assert_close(got["params"], params, TOL)
    # ZeRO-1 ran: gradients reduce-scattered into the moments' blocks and
    # the parameters all-gathered
    assert got["counts"]["reduce_scatter"]["calls"] > 0
    assert got["counts"]["all_gather"]["calls"] > 0


def test_dense_step_matches_where_zero1_cannot_cut(worlds, reference):
    """On 3 ranks no parameter of the reduced qwen3-8b has a dimension
    that 3 divides: every moment stays whole on every rank, every gradient
    is all-reduced, and only rank 0 counts it in the global norm. The step, its loss and its
    norm equal the one-device step's on the same 6-row batch; its
    collectives are `train_collectives`' closed form, the only
    reduce-scatters the model axis's (of size 1: the residual's layer
    exits, the embedding and the head's backward)."""
    got = worlds[3][0]["train_step"]["dense"]
    loss, gnorm, params = _one_device(reference["dense"],
                                      _batch6(reference["dense"]))
    assert abs(got["loss"] - loss) < TOL
    np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=GNORM_RTOL,
                               atol=0)
    _assert_close(got["params"], params, TOL)
    assert got["counts"]["all_reduce"]["calls"] > 0
    # no reduce-scatter but the model axis's own (one of size 1 here): the
    # step's collectives are the closed form's, where ZeRO-1 cuts nothing
    cfg = dataclasses.replace(configs.get_reduced("qwen3-8b"), dtype="float32")
    closed = train_collectives(cfg, ShapeSpec("t", 16, 6, "train"), 3, 1)
    assert got["counts"] == closed
    assert closed["reduce_scatter"]["calls"] == \
        cfg.n_layers * (2 + 1 + 2) + 2


def test_moe_step_matches_reference(worlds, reference):
    got = worlds[4][0]["train_step"]["moe"]
    want = reference["moe"]["dist"]
    assert abs(got["loss"] - want["loss"]) < TOL
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL, atol=0)
    _assert_close(got["params"], _by_port_name(want["params"],
                                               list(got["params"])), TOL)
    assert got["counts"]["all_to_all"]["calls"] > 0


def test_every_rank_ends_with_the_same_parameters(worlds):
    for world in (2, 3, 4):
        ranks = [r["train_step"]["dense"]["params"] for r in worlds[world]]
        for other in ranks[1:]:
            for n in ranks[0]:
                np.testing.assert_array_equal(other[n], ranks[0][n])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_checkpoint_from_two_ranks_restores(worlds, world):
    want = worlds[2][0]["checkpoint_write"]["loss"]
    if world == 2:
        got = worlds[2][0]["checkpoint_write"]["restored"]
        assert got == want
    else:
        got = worlds[world][0]["checkpoint_restore"]["loss"]
        np.testing.assert_allclose(got, want, rtol=RESTORE_RTOL, atol=0)


def test_launcher_resumes_bitwise_over_two_ranks(worlds):
    """A run of 2 steps (``--steps 2``, which checkpoints at step 2), then
    the same command with ``--steps 4`` resuming from that checkpoint,
    gives the uninterrupted 4-step run's losses, bitwise: steps 0-3 lie
    in the schedule's 10-step warm-up, whose learning rates do not depend
    on ``--steps``."""
    for r in worlds[2]:
        got = r["launcher"]
        assert len(got["losses"]) == 4
        assert all(np.isfinite(got["losses"]))
        assert got["sliced"] == got["losses"][:2]
        assert got["start"] == 2 and got["resumed"] == got["losses"][2:]
        assert got["mesh"] == {"data": 2, "model": 1}
        assert all(c["all_reduce"]["calls"] > 0 for c in got["collectives"])
    assert worlds[2][0]["launcher"]["losses"] == worlds[2][1]["launcher"]["losses"]


def test_launcher_refuses_the_model_axis(worlds):
    """Named for what it checked while the launcher refused ``--model``
    above 1: ``--data 1 --model 2`` over a world of 2 now trains, and a
    run of 2 steps resumed to 4 gives the uninterrupted run's losses
    bitwise, within 1e-4 of the data-parallel run's (the same global
    batches and seed, cut the other way)."""
    for r in worlds[2]:
        got = r["launcher"]["model"]
        assert len(got["losses"]) == 4
        assert got["sliced"] == got["losses"][:2]
        assert got["start"] == 2 and got["resumed"] == got["losses"][2:]
        assert got["mesh"] == {"data": 1, "model": 2}
        np.testing.assert_allclose(got["losses"], r["launcher"]["losses"],
                                   rtol=0, atol=1e-4)
        # the model axis's collectives: reduce-scatters of the residual
        # beside ZeRO-1's one a parameter
        assert all(c["reduce_scatter"]["calls"] > 25
                   for c in got["collectives"])
    ranks = worlds[2]
    assert ranks[0]["launcher"]["model"]["losses"] == \
        ranks[1]["launcher"]["model"]["losses"]


def test_local_blocks_and_constrain_over_two_ranks(worlds):
    """A block cut by a spec over 2 ranks has the spec's shape and gathers
    back to the full tensor; `constrain` takes the block of a global shape
    and refuses the full tensor."""
    want = {"('data',)": (2, 6, 2), "(None, 'data')": (4, 3, 2),
            "(None, ('data', 'model'))": (4, 3, 2),
            "('model', 'data', None)": (4, 3, 2), "()": (4, 6, 2)}
    for r in worlds[2]:
        got = r["sharding_helpers"]
        for spec, shape in want.items():
            assert got[spec] == (shape, True), spec
        assert got["constrain"] and got["constrain_refuses"]


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_specs_match_reference(reference, multi_pod, arch):
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = configs.get(arch)
    with parallel_ctx(mesh) as ctx:
        for name, shape in SHAPES.items():
            want = reference["specs"][(multi_pod, arch, name)]
            assert skip_reason(cfg, shape) == want["skip"]
            if shape.kind == "decode":
                cache, tok = decode_input_specs(cfg, shape)
                cs = cache_pspecs(cache, ctx, cfg)
                got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""),
                           _norm(cs[k])) for k, v in cache.items()}
                assert got == want["cache"], name
                assert (tuple(tok.shape), "int32",
                        _norm(batch_pspecs(tok, ctx))) == want["tokens"]
            else:
                b = input_specs(cfg, shape)
                bs = batch_pspecs(b, ctx)
                got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""),
                           _norm(bs[k])) for k, v in b.items()}
                assert got == want["batch"], name
                assert all(v.device.type == "meta" for v in b.values())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_cell_gives_meta_inputs_and_their_specs(kind):
    cfg = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                              n_expert_slots=16)
    mesh = make_production_mesh()
    shape = dataclasses.replace(SHAPES[{"train": "train_4k",
                                        "prefill": "prefill_32k",
                                        "decode": "decode_32k"}[kind]])
    cell = build_cell(cfg, shape, mesh, device="cpu")
    assert cell.mode == kind and len(cell.abstract) == len(cell.specs)
    if kind == "train":
        state, batch = cell.abstract
        p_specs = cell.specs[0]["params"]
        assert set(p_specs) == {n for n, _ in
                                state["params"].named_parameters()}
        # the experts cut over ep = data, their moments too
        name = "blocks.0.moe.w_gate"
        assert p_specs[name][0] == "data"
        assert cell.specs[0]["opt"]["m"][name][0] == "data"
        assert cell.specs[1]["tokens"] == ("data", None)
    else:
        params = cell.abstract[0]
        assert all(p.device.type == "meta" for p in params.parameters())
        assert set(cell.specs[0]) == {n for n, _ in params.named_parameters()}
