"""`repro_torch.parallel.collectives` against `repro.parallel.collectives`.

int8_encode / int8_decode: bitwise, in this process. hierarchical_psum and
compressed_pod_psum: 4 gloo processes as a (pod 2, data 2) mesh
(`_torch_dist.run_world`) against the reference's `shard_map` on 4 fake
host devices of the same shape (`_torch_dist.run_jax`), each rank with
its own input: hierarchical within 1e-6, compressed within 1e-6 relative
of the reference's compressed output, and both within the reference's
0.02 budget of the exact sum (`tests/test_collectives_tuner.py:93`). The
differentiable collectives (psum, psum_scatter, all_gather and all_to_all
over one axis or both) give the reference's outputs and, through their
backward, `jax.grad`'s gradients through the same `shard_map`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_jax, run_world
from repro.parallel import collectives as jcoll
from repro_torch.parallel import collectives as tcoll

TOL = 1e-6
BUDGET = 0.02

# name -> (op, axes, dim)
GRAD_CASES = {
    "psum_data": ("psum", "data", 0),
    "psum_pod": ("psum", "pod", 0),
    "psum_both": ("psum", ("pod", "data"), 0),
    "psum_scatter_data_0": ("psum_scatter", "data", 0),
    "psum_scatter_data_1": ("psum_scatter", "data", 1),
    "psum_scatter_both_0": ("psum_scatter", ("pod", "data"), 0),
    "all_gather_data_0": ("all_gather", "data", 0),
    "all_gather_pod_1": ("all_gather", "pod", 1),
    "all_gather_both_1": ("all_gather", ("pod", "data"), 1),
    "all_to_all_data": ("all_to_all", "data", 0),
    "all_to_all_pod": ("all_to_all", "pod", 0),
    "all_to_all_both": ("all_to_all", ("pod", "data"), 0),
}

JAX_SCRIPT = r"""
import pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.parallel.collectives import compressed_pod_psum, hierarchical_psum

CASES = %(cases)r
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("pod", "data"))
spec = P(("pod", "data"))
rng = np.random.default_rng(0)
x = rng.standard_normal((4, 8, 16)).astype(np.float32)
xg = rng.standard_normal((4, 8, 16)).astype(np.float32)


def per_device(f, a):
    out = shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                    check_rep=False)(jnp.asarray(a.reshape(-1, *a.shape[2:])))
    return np.asarray(out).reshape(4, -1, *out.shape[1:])


OPS = {
    "psum": lambda v, axes, dim: jax.lax.psum(v, axes),
    "psum_scatter": lambda v, axes, dim: jax.lax.psum_scatter(
        v, axes, scatter_dimension=dim, tiled=True),
    "all_gather": lambda v, axes, dim: jax.lax.all_gather(
        v, axes, axis=dim, tiled=True),
    "all_to_all": lambda v, axes, dim: jax.lax.all_to_all(
        v, axes, 0, 0, tiled=True),
}
out = {"x": x, "xg": xg, "w": {}, "grad": {}, "y": {}}
out["hierarchical"] = per_device(
    lambda v: hierarchical_psum(v, "pod", "data"), x)
out["compressed"] = per_device(
    lambda v: compressed_pod_psum(v, "pod", "data"), x)
for key, (op, axes, dim) in CASES.items():
    f = lambda v, op=op, axes=axes, dim=dim: OPS[op](v, axes, dim)
    y = per_device(f, xg)
    w = rng.standard_normal(y.shape).astype(np.float32)
    wf = jnp.asarray(w.reshape(-1, *w.shape[2:]))

    def loss(a, f=f, wf=wf):
        yy = shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                       check_rep=False)(a)
        return jnp.sum(yy * wf)

    g = jax.grad(loss)(jnp.asarray(xg.reshape(-1, 16)))
    out["y"][key], out["w"][key] = y, w
    out["grad"][key] = np.asarray(g).reshape(4, 8, 16)
with open(OUT, "wb") as f:
    pickle.dump(out, f)
""" % {"cases": GRAD_CASES}


@pytest.fixture(scope="module")
def tmp_mod(tmp_path_factory):
    return tmp_path_factory.mktemp("collectives")


@pytest.fixture(scope="module")
def reference(tmp_mod):
    return run_jax(JAX_SCRIPT, tmp_mod / "jax")


@pytest.fixture(scope="module")
def port(reference, tmp_mod):
    payload = {"x": reference["x"], "xg": reference["xg"],
               "w": reference["w"], "grad_cases": GRAD_CASES}
    return run_world(4, {"collectives": payload, "collectives_exact": {}},
                     tmp_mod / "w4")


def _int8_inputs():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, -0.5, 1.5, 2.5, -2.5, 63.5, -63.5],
                    np.float32) / 127.0
    return {"normal": rng.standard_normal((64, 33)).astype(np.float32),
            "wide": (rng.standard_normal(1000) * 1e4).astype(np.float32),
            "ties": ties, "zeros": np.zeros(7, np.float32)}


@pytest.mark.parametrize("name", list(_int8_inputs()))
def test_int8_encode_decode_bitwise(name):
    x = _int8_inputs()[name]
    jq, jscale = jcoll.int8_encode(jnp.asarray(x))
    tq, tscale = tcoll.int8_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    jd = jcoll.int8_decode(jq, jscale)
    td = tcoll.int8_decode(tq, tscale)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_hierarchical_psum_matches_reference(port, reference):
    exact = reference["x"].sum(0)
    for r, got in enumerate(g["collectives"] for g in port):
        np.testing.assert_allclose(got["hierarchical"],
                                   reference["hierarchical"][r], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got["hierarchical"], exact, rtol=0,
                                   atol=TOL)
    c = port[0]["collectives"]["counts"]
    assert c["reduce_scatter"]["calls"] == 2 and c["all_reduce"]["calls"] == 1


def test_compressed_pod_psum_matches_reference(port, reference):
    exact = reference["x"].sum(0)
    scale = np.max(np.abs(exact))
    for r, got in enumerate(g["collectives"] for g in port):
        want = reference["compressed"][r]
        assert np.max(np.abs(got["compressed"] - want)) / scale < TOL
        assert np.max(np.abs(got["compressed"] - exact)) / scale < BUDGET
        assert np.max(np.abs(want - exact)) / scale < BUDGET


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_collective_and_its_gradient_match_reference(port, reference, case):
    for r, got in enumerate(g["collectives"] for g in port):
        y, g = got[case]
        np.testing.assert_allclose(y, reference["y"][case][r], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(g, reference["grad"][case][r], rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("op", ["psum", "psum_scatter", "all_gather",
                                "all_to_all"])
def test_collectives_exact_on_four_ranks(port, op):
    """On small integers every collective is exact: each rank's result is
    the one computed from all ranks' inputs (the same check the card runs
    over NCCL on two cards)."""
    for r in port:
        got, want = r["collectives_exact"][op]
        np.testing.assert_array_equal(got, want)
