"""Tensor-parallel training of the other families across ranks, against
the reference's one-device step and the port's.

The port runs over gloo process groups of 1, 2 and 4 CPU processes
(`_torch_dist.run_world`), each case on its own (data, model) mesh; the
reference's one-device steps of every family run in one subprocess
(`_torch_dist.run_jax`). One ZeRO-1 step of each float32 reduced config
(global batch 4, 16 tokens; whisper 8 frames and 8 tokens, internvl2 16
patches before 16 tokens):

- yi-34b-reduced on (1, 2): 7 heads, so attention runs whole on both
  ranks and its parameters' gradients are summed over the model axis;
- zamba2-1.2b-reduced on (1, 2) and (2, 2): Mamba2 on its local heads
  (`Segments` projections, B8/B8b's plain versions on 2 heads), the
  shared attention block on the gathered [h, e0];
- xlstm-350m-reduced on (1, 2): the mLSTM on one head a rank, the sLSTM
  whole;
- whisper-small-reduced on (1, 2): the frames cut over d, the encoder
  memory gathered once for the cross attention;
- internvl2-26b-reduced on (1, 2): the patches cut over d.

Each is held to the reference's one-device step and the port's within
1e-4 in the loss and every parameter, the global gradient norm within
rtol 1e-5 (`tests/test_torch_tp_train.py` says why), with AdamW's eps at
1e-6 on both sides (`EPS` says why); at (1, 1) every family's step equals
the port's one-device step bitwise.
"""
import numpy as np
import pytest

from _torch_dist import run_jax, run_world

TOL = 1e-4
GNORM_RTOL = 1e-5
# AdamW's eps in these steps, on both sides. A first step moves a weight
# by lr g / (|g| + eps): where |g| is below eps the move is rounding noise
# over eps, and a float32 gradient summed in another order than XLA's
# moves it by up to lr 1e-9 / eps. At the default 1e-8 that is 1e-4, the
# bound itself: zamba2-1.2b-reduced's one-device step, which this slice
# does not touch, sits 8.3e-5 from the reference's on a weight whose
# gradient is 8e-9 (1.3e-4 with seeds 20-24). At 1e-6 that noise is 1e-6, while a gradient that is
# missing or of the wrong sign still moves a weight by about lr (1e-3).
EPS = 1e-6

ARCHS = ["yi-34b", "zamba2-1.2b", "xlstm-350m", "whisper-small",
         "internvl2-26b"]

JAX_SCRIPT = r"""
import dataclasses, pickle
import jax, jax.numpy as jnp
import numpy as np
from repro import configs
from repro.train import AdamW, init_state, make_train_step

np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {}


def batch_of(cfg, seed, B=4, T=16):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        T = T // 2
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = (0.1 * rng.standard_normal(
            (B, T, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = (0.1 * rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model))).astype(np.float32)
    return batch


for i, arch in enumerate(ARCHS):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    opt = AdamW(lr=1e-3, eps=EPS, zero1=True)
    state = np_tree(init_state(cfg, jax.random.PRNGKey(10 + i), opt))
    batch = batch_of(cfg, 10 + i)
    fn = jax.jit(make_train_step(cfg, opt, 1))
    s2, m2 = fn(jax.tree_util.tree_map(jnp.asarray, state),
                jax.tree_util.tree_map(jnp.asarray, batch))
    out[arch] = {"state": state, "batch": batch,
                 "one": {"loss": float(m2["loss"]),
                         "grad_norm": float(m2["grad_norm"]),
                         "params": np_tree(s2["params"])}}

with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""

# (arch, mesh) of each case run on more than one rank
CASES = [("yi-34b", (1, 2)), ("zamba2-1.2b", (1, 2)), ("zamba2-1.2b", (2, 2)),
         ("xlstm-350m", (1, 2)), ("whisper-small", (1, 2)),
         ("internvl2-26b", (1, 2))]


@pytest.fixture(scope="module")
def tmp_mod(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_families")


@pytest.fixture(scope="module")
def reference(tmp_mod):
    return run_jax(f"ARCHS = {ARCHS!r}\nEPS = {EPS!r}\n" + JAX_SCRIPT,
                   tmp_mod / "jax")


def _case(ref, arch, mesh, **extra):
    return {"arch": arch, "state": ref[arch]["state"],
            "batch": ref[arch]["batch"], "mesh": mesh, "eps": EPS, **extra}


@pytest.fixture(scope="module")
def worlds(reference, tmp_mod):
    out = {1: run_world(1, {"tp_train_step": {
        arch: _case(reference, arch, (1, 1), one_device=True)
        for arch in ARCHS}}, tmp_mod / "w1")}
    for world in (2, 4):
        cases = {f"{a}@{m}": _case(reference, a, m) for a, m in CASES
                 if m[0] * m[1] == world}
        out[world] = run_world(world, {"tp_train_step": cases},
                               tmp_mod / f"w{world}")
    return out


def _by_port_name(tree, names):
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


@pytest.mark.parametrize("arch,mesh", CASES)
@pytest.mark.parametrize("against", ["port_one_device", "reference"])
def test_family_tp_step_matches(worlds, reference, arch, mesh, against):
    got = worlds[mesh[0] * mesh[1]][0]["tp_train_step"][f"{arch}@{mesh}"]
    if against == "port_one_device":
        want = worlds[1][0]["tp_train_step"][arch]["one_device"]
        params = want["params"]
    else:
        want = reference[arch]["one"]
        params = _by_port_name(want["params"], list(got["params"]))
    assert abs(got["loss"] - want["loss"]) < TOL
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL, atol=0)
    assert set(got["params"]) == set(params)
    worst = max(float(np.max(np.abs(got["params"][n] - params[n])))
                for n in params)
    assert worst < TOL, worst
    assert got["counts"]["all_gather"]["calls"] > len(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_of_one_is_the_one_device_step_bitwise(worlds, arch):
    got = worlds[1][0]["tp_train_step"][arch]
    want = got["one_device"]
    assert got["loss"] == want["loss"]
    assert got["grad_norm"] == want["grad_norm"]
    for n, p in want["params"].items():
        np.testing.assert_array_equal(got["params"][n], p, err_msg=n)


def test_every_rank_ends_with_the_same_parameters(worlds):
    for world in (2, 4):
        for key in worlds[world][0]["tp_train_step"]:
            ranks = [r["tp_train_step"][key]["params"] for r in worlds[world]]
            for other in ranks[1:]:
                for n in ranks[0]:
                    np.testing.assert_array_equal(other[n], ranks[0][n],
                                                  err_msg=f"{key} {n}")

