"""Tensor-parallel training of the dense and MoE families across ranks,
and checkpoints across meshes, against the reference.

The port runs over gloo process groups of 1, 2 and 4 CPU processes
(`_torch_dist.run_world`), each case on its own (data, model) mesh; the
reference runs in one subprocess on 4 fake host devices
(`_torch_dist.run_jax`): its one-device step, and its distributed step on
a fake (data 2, model 2) mesh, as `tests/test_sharding_dist.py` holds it
to its one-device step.

- Dense: one ZeRO-1 step of float32 reduced qwen3-8b (global batch 4) on
  (1, 2) and (2, 2) under both residual layouts, and on (1, 4), where its
  2 kv heads are replicated: the loss and every parameter after the step
  within 1e-4 (the reference's own bound, `tests/test_sharding_dist.py`)
  of the port's one-device step, of the reference's one-device step and
  of the reference's (2, 2) step; the global gradient norm within rtol
  1e-5 (one AdamW step from zero moments moves each entry by about the
  learning rate whatever the gradient's scale, so only the norm sees a
  gradient counted twice over the model axis). At (1, 1) the step equals
  the one-device step bitwise, under both layouts.
- Uneven shapes on (1, 2), against the port's and the reference's
  one-device steps: 6 q heads over 3 kv heads (each rank's q heads use
  2 kv heads unevenly), and a vocabulary of 255 under both layouts (the
  embedding and the head whole).
- MoE: the reduced kimi-k2 with 8 expert slots (perturbed apart) on
  (2, 2) under both layouts, `moe_sharded` at tp 2, against the
  reference's (2, 2) step and the port's (2, 1) step, to the same bounds.
- Every rank ends a (2, 2) step with the same whole parameters.
- Checkpoints: zamba2-1.2b-reduced (its packed Mamba projections cut as
  `Segments`) written on (2, 2) restores on (2, 2), (4, 1), (1, 4) and
  (1, 1); the next step's loss equals the uninterrupted run's bitwise on
  the same mesh and within rtol 1e-6 elsewhere.
"""
import dataclasses

import numpy as np
import pytest

from _torch_dist import run_jax, run_world
from repro_torch import configs

TOL = 1e-4
GNORM_RTOL = 1e-5
RESTORE_RTOL = 1e-6

JAX_SCRIPT = r"""
import dataclasses, pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.parallel import parallel_ctx
from repro.parallel.sharding import default_rules
from repro.train import AdamW, init_state, make_train_step

np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
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


def step(cfg, state, batch, dist):
    fn = make_train_step(cfg, AdamW(lr=1e-3, zero1=True), 1)
    args = (jax.tree_util.tree_map(jnp.asarray, state),
            jax.tree_util.tree_map(jnp.asarray, batch))
    if dist:
        def wrapped(s, b):
            with parallel_ctx(mesh, rules):
                return fn(s, b)
        with parallel_ctx(mesh, rules):
            s2, m2 = jax.jit(wrapped)(*args)
    else:
        s2, m2 = jax.jit(fn)(*args)
    return {"loss": float(m2["loss"]), "grad_norm": float(m2["grad_norm"]),
            "params": np_tree(s2["params"])}


dense = dataclasses.replace(configs.get_reduced("qwen3-8b"), dtype="float32")
state = np_tree(init_state(dense, jax.random.PRNGKey(5),
                           AdamW(lr=1e-3, zero1=True)))
batch = batch_of(dense, 5)
out["dense"] = {"state": state, "batch": batch,
                "one": step(dense, state, batch, False),
                "dist": step(dense, state, batch, True),
                "dist_replicated": step(dataclasses.replace(
                    dense, residual="replicated"), state, batch, True)}

# 6 q heads over 3 kv heads: on 2 ranks each rank's 3 q heads use 2 kv
# heads unevenly; a vocabulary of 255 that 2 does not divide
for key, kw in (("dense_uneven_kv", dict(n_heads=6, n_kv_heads=3,
                                         head_dim=16)),
                ("dense_odd_vocab", dict(vocab_size=255))):
    cfg = dataclasses.replace(dense, **kw)
    state = np_tree(init_state(cfg, jax.random.PRNGKey(7),
                               AdamW(lr=1e-3, zero1=True)))
    batch = batch_of(cfg, 7)
    out[key] = {"state": state, "batch": batch,
                "one": step(cfg, state, batch, False)}

moe = dataclasses.replace(configs.get_reduced("kimi-k2-1t-a32b"),
                          dtype="float32", n_expert_slots=8)
state = np_tree(init_state(moe, jax.random.PRNGKey(6),
                           AdamW(lr=1e-3, zero1=True)))
state["params"] = perturb(state["params"], 6)
batch = batch_of(moe, 6)
out["moe"] = {"state": state, "batch": batch,
              "dist": step(moe, state, batch, True)}

with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def tmp_mod(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_train")


@pytest.fixture(scope="module")
def reference(tmp_mod):
    return run_jax(JAX_SCRIPT, tmp_mod / "jax")


def _case(ref, arch, mesh, **replace):
    return {"arch": arch, "state": ref["state"], "batch": ref["batch"],
            "mesh": mesh, "replace": replace}


UNEVEN = {"n_heads": 6, "n_kv_heads": 3, "head_dim": 16}
ODD = {"vocab_size": 255}


@pytest.fixture(scope="module")
def worlds(reference, tmp_mod):
    dense, moe = reference["dense"], reference["moe"]
    uneven, odd = reference["dense_uneven_kv"], reference["dense_odd_vocab"]
    rep = {"residual": "replicated"}
    slots = {"n_expert_slots": 8}
    ckpt = {"arch": "zamba2-1.2b", "dir": str(tmp_mod / "ckpt")}
    out = {}
    out[1] = run_world(1, {"tp_train_step": {
        "dense": dict(_case(dense, "qwen3-8b", (1, 1)), one_device=True),
        "dense_replicated": dict(_case(dense, "qwen3-8b", (1, 1), **rep),
                                 one_device=True),
        "dense_uneven_kv": dict(_case(uneven, "qwen3-8b", (1, 1), **UNEVEN),
                                one_device=True),
        "dense_odd_vocab": dict(_case(odd, "qwen3-8b", (1, 1), **ODD),
                                one_device=True)}}, tmp_mod / "w1a")
    out[2] = run_world(2, {"tp_train_step": {
        "dense": _case(dense, "qwen3-8b", (1, 2)),
        "dense_replicated": _case(dense, "qwen3-8b", (1, 2), **rep),
        "dense_uneven_kv": _case(uneven, "qwen3-8b", (1, 2), **UNEVEN),
        "dense_odd_vocab": _case(odd, "qwen3-8b", (1, 2), **ODD),
        "dense_odd_vocab_replicated": _case(odd, "qwen3-8b", (1, 2), **ODD,
                                            **rep),
        "moe_data_only": _case(moe, "kimi-k2-1t-a32b", (2, 1), **slots)}},
        tmp_mod / "w2")
    out[4] = run_world(4, {
        "tp_train_step": {
            "dense": _case(dense, "qwen3-8b", (2, 2)),
            "dense_replicated": _case(dense, "qwen3-8b", (2, 2), **rep),
            "dense_kv_replicated": _case(dense, "qwen3-8b", (1, 4)),
            "moe": _case(moe, "kimi-k2-1t-a32b", (2, 2), **slots),
            "moe_replicated": _case(moe, "kimi-k2-1t-a32b", (2, 2), **slots,
                                    **rep)},
        "tp_checkpoint": dict(ckpt, write=True,
                              meshes=[(2, 2), (4, 1), (1, 4)])},
        tmp_mod / "w4")
    out["restore1"] = run_world(1, {"tp_checkpoint": dict(
        ckpt, write=False, meshes=[(1, 1)])}, tmp_mod / "w1b")
    return out


def _by_port_name(tree, names):
    """Leaf `blocks.3.attn.w_q` of the port is layer 3 of the reference's
    stacked `blocks.attn.w_q`."""
    out = {}
    for name in names:
        layer, node = None, tree
        for part in name.split("."):
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


def _held(got, loss, gnorm, params):
    assert abs(got["loss"] - loss) < TOL
    np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=GNORM_RTOL,
                               atol=0)
    _assert_close(got["params"], params, TOL)


DENSE_CASES = [("dense", 2), ("dense", 4), ("dense_replicated", 2),
               ("dense_replicated", 4), ("dense_kv_replicated", 4)]


@pytest.mark.parametrize("key,world", DENSE_CASES)
@pytest.mark.parametrize("against", ["port_one_device", "reference",
                                     "reference_distributed"])
def test_dense_tp_step_matches(worlds, reference, key, world, against):
    got = worlds[world][0]["tp_train_step"][key]
    ref = reference["dense"]
    if against == "port_one_device":
        want = worlds[1][0]["tp_train_step"]["dense"]["one_device"]
        _held(got, want["loss"], want["grad_norm"], want["params"])
    else:
        want = ref["one" if against == "reference" else
                   ("dist_replicated" if "replicated" in key and
                    key != "dense_kv_replicated" else "dist")]
        _held(got, want["loss"], want["grad_norm"],
              _by_port_name(want["params"], list(got["params"])))
    c = got["counts"]
    if key == "dense_replicated":
        # row-parallel exits summed whole: no reduce-scatter of the
        # residual, only ZeRO-1's (one a parameter)
        assert c["reduce_scatter"]["calls"] == len(got["params"])
    else:
        assert c["reduce_scatter"]["calls"] > len(got["params"])


@pytest.mark.parametrize("key,against", [
    ("dense_uneven_kv", "port_one_device"), ("dense_uneven_kv", "reference"),
    ("dense_odd_vocab", "port_one_device"), ("dense_odd_vocab", "reference"),
    ("dense_odd_vocab_replicated", "port_one_device"),
    ("dense_odd_vocab_replicated", "reference")])
def test_dense_tp_step_matches_on_uneven_shapes(worlds, reference, key,
                                                against):
    """On (1, 2): 3 q heads a rank over 2 of the 3 kv heads each, unevenly
    (a kv head selected per q head); and a vocabulary of 255, which the
    axis does not divide, so the embedding and the head run whole (the
    head's input gathered whole with a backward that keeps each rank's
    block)."""
    got = worlds[2][0]["tp_train_step"][key]
    base = key.replace("_replicated", "")
    if against == "port_one_device":
        want = worlds[1][0]["tp_train_step"][base]["one_device"]
        _held(got, want["loss"], want["grad_norm"], want["params"])
    else:
        want = reference[base]["one"]
        _held(got, want["loss"], want["grad_norm"],
              _by_port_name(want["params"], list(got["params"])))


@pytest.mark.parametrize("key", ["dense", "dense_replicated",
                                 "dense_uneven_kv", "dense_odd_vocab"])
def test_model_axis_of_one_is_the_one_device_step_bitwise(worlds, key):
    got = worlds[1][0]["tp_train_step"][key]
    want = got["one_device"]
    assert got["loss"] == want["loss"]
    assert got["grad_norm"] == want["grad_norm"]
    for n, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][n], p, err_msg=n)
    # the model axis's collectives ran, each over one rank
    assert got["counts"]["all_reduce"]["calls"] > 2


@pytest.mark.parametrize("key", ["moe", "moe_replicated"])
@pytest.mark.parametrize("against", ["reference_distributed",
                                     "port_data_only"])
def test_moe_tp_step_matches(worlds, reference, key, against):
    """Under residual "replicated" `moe_sharded` takes each rank's slice
    of the whole normed input and its output is summed back whole."""
    got = worlds[4][0]["tp_train_step"][key]
    if against == "port_data_only":
        want = worlds[2][0]["tp_train_step"]["moe_data_only"]
        _held(got, want["loss"], want["grad_norm"], want["params"])
    else:
        want = reference["moe"]["dist"]
        _held(got, want["loss"], want["grad_norm"],
              _by_port_name(want["params"], list(got["params"])))
    assert got["counts"]["all_to_all"]["calls"] > 0


def test_every_rank_ends_with_the_same_parameters(worlds):
    for key in ("dense", "dense_replicated", "moe", "moe_replicated"):
        ranks = [r["tp_train_step"][key]["params"] for r in worlds[4]]
        for other in ranks[1:]:
            for n in ranks[0]:
                np.testing.assert_array_equal(other[n], ranks[0][n])


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1), (1, 4), (1, 1)])
def test_checkpoint_from_a_model_axis_restores(worlds, mesh):
    want = worlds[4][0]["tp_checkpoint"]["loss"]
    if mesh == (1, 1):
        got = worlds["restore1"][0]["tp_checkpoint"][mesh]
    else:
        got = worlds[4][0]["tp_checkpoint"][mesh]
    if mesh == (2, 2):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=RESTORE_RTOL, atol=0)


def test_layout_of_the_cases():
    """qwen3-8b-reduced's 2 kv heads split over 2 ranks but not 4, so the
    (1, 4) case takes the replicated-kv path; kimi-k2-reduced's shared
    expert and its router split over 2."""
    q = configs.get_reduced("qwen3-8b")
    assert q.n_kv_heads % 2 == 0 and q.n_kv_heads % 4 != 0
    assert q.heads_eff % 4 == 0
    k = dataclasses.replace(configs.get_reduced("kimi-k2-1t-a32b"),
                            n_expert_slots=8)
    assert (k.moe_d_ff * k.n_shared_experts) % 2 == 0 and k.d_model % 2 == 0
