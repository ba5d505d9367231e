"""Expert parallelism: `moe_sharded` against the reference's.

Float32 reduced qwen2-moe and kimi-k2 with 8 expert slots (as
`tests/test_sharding_dist.py:75-76` sets it, so that 4 and 2 divide
them), each slot perturbed apart (the reference's init makes every expert
the same draw). On (ep 4, tp 1) and (ep 2, tp 2) meshes, at the config's
capacity factor (slots dropped) and at one that drops none, the port runs
over 4 gloo processes (`_torch_dist.run_world`) and the reference on 4
fake host devices (`_torch_dist.run_jax`). The output and the gradients
of x, of the router and expert weights and of the shared expert agree to
1e-5 and 1e-4. Every token shares one random direction, which skews the
routing so that each dropping case drops slots, and some case of each
config overflows a destination group (where the reference also loses the
group's position-0 slot; the port repeats that,
`models.moe._slot_experts`). At a world of one,
`moe_sharded` is `moe_ref` at capacity C2, bitwise, forward and backward.
"""
import numpy as np
import pytest

from _torch_dist import run_jax, run_world

ARCHS = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
MESHES = ((4, 1), (2, 2))
REGIMES = {"dropping": 1.25, "dropless": 8.0}
TOL_Y = 1e-5
TOL_G = 1e-4
B, T = 4, 8

JAX_SCRIPT = r"""
import dataclasses, pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.models import moe as jmoe

ARCHS = %(archs)r
MESHES = %(meshes)r
REGIMES = %(regimes)r
B, T = %(B)d, %(T)d
np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {}
for ai, arch in enumerate(ARCHS):
    base = dataclasses.replace(configs.get_reduced(arch), n_expert_slots=8)
    tree = np_tree(jmoe.init_moe(jax.random.PRNGKey(ai), base.d_model, base,
                                 jnp.float32))
    rng = np.random.default_rng(ai)
    for key in ("w_gate", "w_up", "w_down"):
        w = tree[key]
        tree[key] = (w + 0.5 * np.abs(w).mean()
                     * rng.standard_normal(w.shape)).astype(np.float32)
    # a direction shared by every token skews the routing, so that the
    # config's capacity factor drops slots at both stages
    x = (rng.standard_normal((B, T, base.d_model))
         + rng.standard_normal(base.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, T, base.d_model)).astype(np.float32)
    for regime, cf in REGIMES.items():
        cfg = dataclasses.replace(base, capacity_factor=cf)
        for ep, tp in MESHES:
            mesh = Mesh(np.array(jax.devices()).reshape(ep, tp),
                        ("data", "model"))

            def loss(x, p):
                y = jmoe.moe_sharded(x, p, cfg, mesh, ep_axes=("data",),
                                     tp_axis="model")
                return jnp.sum(y * dy), y

            (_, y), (gx, gp) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(
                jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, tree))
            out[(arch, regime, ep, tp)] = {
                "y": np.asarray(y), "x": np.asarray(gx), "grads": np_tree(gp)}
    out[arch] = {"params": tree, "x": x, "dy": dy}
with open(OUT, "wb") as f:
    pickle.dump(out, f)
""" % {"archs": ARCHS, "meshes": MESHES, "regimes": REGIMES, "B": B, "T": T}


@pytest.fixture(scope="module")
def tmp_mod(tmp_path_factory):
    return tmp_path_factory.mktemp("moe_sharded")


@pytest.fixture(scope="module")
def reference(tmp_mod):
    return run_jax(JAX_SCRIPT, tmp_mod / "jax")


def _case(reference, arch, regime, mesh=None):
    case = dict(reference[arch], arch=arch, cf=REGIMES[regime])
    if mesh is not None:
        case["mesh"] = mesh
    return case


@pytest.fixture(scope="module")
def port(reference, tmp_mod):
    four = {(a, r, *m): _case(reference, a, r, m)
            for a in ARCHS for r in REGIMES for m in MESHES}
    one = {(a, r): _case(reference, a, r) for a in ARCHS for r in REGIMES}
    return {4: run_world(4, {"moe_sharded": four}, tmp_mod / "w4"),
            1: run_world(1, {"moe_one_rank": one, "moe_remat_backward": {}},
                         tmp_mod / "w1")[0]}


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"ep{m[0]}_tp{m[1]}")
@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sharded_matches_reference(port, reference, arch, regime, mesh):
    key = (arch, regime, *mesh)
    want = reference[key]
    ranks = [r["moe_sharded"][key] for r in port[4]]
    got = ranks[0]
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=TOL_Y)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=TOL_G)
    names = [k for k in got if k.startswith(("w_", "shared."))]
    assert len(names) == 7       # router, three experts, shared expert
    for name in names:
        np.testing.assert_allclose(got[name], _leaf(want["grads"], name),
                                   rtol=0, atol=TOL_G, err_msg=name)
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["y"], got["y"])
    first, second = got["drops"]
    if regime == "dropless":
        assert first == second == 0
    else:
        assert first + second > 0
    # forward: tokens and expert ids out, outputs back; backward: the two
    # token trips again; the three expert products scattered over tp
    c = got["counts"]
    assert c["all_to_all"]["calls"] == 5
    assert c["reduce_scatter"]["calls"] >= 3


@pytest.mark.parametrize("arch", ARCHS)
def test_a_first_stage_overflow_is_covered(port, arch):
    """Some dropping case of each config overflows a destination group,
    where the reference also loses that group's position-0 slot."""
    assert any(v["drops"][0] > 0 for k, v in port[4][0]["moe_sharded"].items()
               if k[:2] == (arch, "dropping"))


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_moe_ref_at_c2_bitwise(port, arch, regime):
    got = port[1]["moe_one_rank"][(arch, regime)]
    ys, yr = got["y"]
    np.testing.assert_array_equal(ys, yr)
    assert len(got["grads"]) == 8
    for a, b in got["grads"]:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("where", ["after", "thread"])
def test_remat_recomputes_through_moe_sharded(port, where):
    """Under remat the backward recomputes each layer inside the forward's
    parallel context, wherever it runs: after the context has closed, or
    on another thread, as autograd runs a backward on the card. Outside
    the context the recomputation would take `moe_ref` and save other
    tensors than the forward did."""
    got = port[1]["moe_remat_backward"]
    assert len(got[where]) == len(got["inside"])
    for a, b in zip(got[where], got["inside"]):
        np.testing.assert_array_equal(a, b)
