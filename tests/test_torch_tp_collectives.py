"""Tensor parallelism's building blocks on the CPU: the conjugate sums, the
`Segments` blocks, the port's layout against the reference's specs, and
the closed-form collective count of a training step.

- The sums (`parallel.collectives`), on 2 gloo ranks of a (data 1, model
  2) mesh: a sum that every rank consumes whole (`psum_replicated`), a
  replicated tensor entering work each rank does a part of
  (`replicated_copy`) and a vocab-parallel logsumexp shifted by `pmax`
  give `jax.grad`'s gradients of the same functions on the whole arrays;
  the old `psum` gives twice the gradient there, and without the copy
  each rank holds only its own part.
- `Segments`: a packed dimension cut segment by segment, gathered back.
- The layout: every departure of `parallel.sharding.tp_pspecs` from the
  reference's `param_pspecs`, per config, on the production mesh (full
  widths) and on a (data 1, model 4) mesh (reduced configs), listed here
  so that a new one cannot slip in unlisted.
- The count: one step of the reduced qwen3-8b on (1, 2) under each
  residual layout, with 1 and 2 microbatches, runs the collectives
  `launch.specs.train_collectives` writes from the config, call for call
  and byte for byte.
Serving over the model axis is held to the reference in
`tests/test_torch_tp_serve.py`.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_world
from repro_torch import configs
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.zoo import LM
from repro_torch.parallel import param_pspecs, parallel_ctx
from repro_torch.parallel.sharding import Segments, tp_pspecs

R, V = 3, 5


def _payload():
    rng = np.random.default_rng(26)
    f32 = np.float32
    return {"u": rng.standard_normal((2, R, V)).astype(f32),
            "c": rng.standard_normal((R, V)).astype(f32),
            "z": rng.standard_normal((R, V)).astype(f32),
            "a": rng.standard_normal((2, R, V)).astype(f32),
            "x": 3 * rng.standard_normal((2, R, V)).astype(f32),
            "w": rng.standard_normal((R,)).astype(f32)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_collectives")
    payload = _payload()
    return payload, run_world(2, {"tp_conjugates": payload,
                                  "tp_counts": {"seq": 16, "batch": 4}},
                              tmp / "w2")


def _jax_grads(p):
    c, a = jnp.asarray(p["c"]), jnp.asarray(p["a"])

    def sum_whole(u):                       # u: the ranks' blocks (2, R, V)
        return jnp.sum(c * jnp.sum(u, 0) ** 2)

    def copy_partial(z):
        return jnp.sum((a * z[None]) ** 2)

    def lse(x):                             # x: (2, R, V) vocab blocks
        full = jnp.concatenate([x[0], x[1]], -1)
        return jnp.sum(jnp.asarray(p["w"]) * jax.nn.logsumexp(full, -1))

    x = jnp.asarray(p["x"])
    full = jnp.concatenate([x[0], x[1]], -1)
    return {"sum": np.asarray(jax.grad(sum_whole)(jnp.asarray(p["u"]))),
            "copy": np.asarray(jax.grad(copy_partial)(jnp.asarray(p["z"]))),
            "lse": np.asarray(jax.nn.logsumexp(full, -1)),
            "dlse": np.asarray(jax.grad(lse)(x)),
            "max": np.asarray(jnp.max(full, -1))}


def test_psum_replicated_gives_the_whole_gradient(world2):
    payload, ranks = world2
    want = _jax_grads(payload)["sum"]
    for r, got in enumerate(ranks):
        got = got["tp_conjugates"]
        np.testing.assert_allclose(got["psum_replicated"], want[r],
                                   rtol=1e-6, atol=1e-6)
        # the reference's transpose (psum <-> psum) counts it twice
        np.testing.assert_allclose(got["psum"], 2 * want[r], rtol=1e-6,
                                   atol=1e-6)


def test_replicated_copy_sums_the_partial_gradients(world2):
    payload, ranks = world2
    want = _jax_grads(payload)["copy"]
    a, z = payload["a"], payload["z"]
    for r, got in enumerate(ranks):
        got = got["tp_conjugates"]
        np.testing.assert_allclose(got["replicated_copy"], want, rtol=1e-6,
                                   atol=1e-6)
        # without the copy a rank holds only its own part
        np.testing.assert_allclose(got["no_copy"], 2 * a[r] ** 2 * z,
                                   rtol=1e-6, atol=1e-6)


def test_pmax_and_the_vocab_parallel_logsumexp(world2):
    payload, ranks = world2
    want = _jax_grads(payload)
    for r, got in enumerate(ranks):
        got = got["tp_conjugates"]
        m, needs_grad = got["pmax"]
        np.testing.assert_array_equal(m, want["max"])
        assert not needs_grad
        lse, dx = got["lse"]
        np.testing.assert_allclose(lse, want["lse"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dx, want["dlse"][r], rtol=1e-5, atol=1e-6)


def test_segments_cut_and_gather_back(world2):
    """Columns (4 | 4 | 2 | 2 | 10) with the first, second and last cut:
    rank r holds (2 | 2 | 2 | 2 | 5) columns, its blocks of the cut ones."""
    _, ranks = world2
    full = np.arange(2 * 22, dtype=np.float32).reshape(2, 22)
    for r, got in enumerate(ranks):
        shape, block, back = got["tp_conjugates"]["segments"]
        assert shape == (2, 13) and back
        want = np.concatenate([full[:, 2 * r:2 * r + 2],
                               full[:, 4 + 2 * r:6 + 2 * r], full[:, 8:12],
                               full[:, 12 + 5 * r:17 + 5 * r]], 1)
        np.testing.assert_array_equal(block, want)


@pytest.mark.parametrize("residual", ["tp", "replicated"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_step_runs_the_closed_form_collectives(world2, residual,
                                               microbatches):
    for got in world2[1]:
        counted, closed = got["tp_counts"][(residual, microbatches)]
        assert counted == closed


# ---------------------------------------------------------------------------
# the layout's departures from the reference's specs
# ---------------------------------------------------------------------------

W = (None, None)          # a 2-dim weight replicated whole
ATTN_WHOLE = {"attn.w_q": W, "attn.w_k": W, "attn.w_v": W, "attn.w_o": W}
KV = {"attn.w_k": W, "attn.w_v": W}


def _mamba(di, S, H):
    return {"mamba.w_in": (None, Segments((di, di, S, S, H),
                                          (True, True, False, False, True),
                                          "model")),
            "mamba.conv_w": (None, Segments((di, S, S), (True, False, False),
                                            "model"))}


def _blocks(prefix, d):
    return {f"{prefix}.*.{k}": v for k, v in d.items()}


XLSTM = {"pairs.*.mlstm.w_q": W, "pairs.*.mlstm.w_k": W,
         "pairs.*.mlstm.w_v": W, "pairs.*.mlstm.w_out": W,
         "pairs.*.slstm.w_x": W, "pairs.*.slstm.w_h": W,
         "pairs.*.slstm.w_out": W}

# (arch, mesh) -> {parameter (layer index as *): the port's spec}
DEPARTURES = {
    ("qwen3-8b", "production"): _blocks("blocks", KV),
    ("qwen3-8b", "reduced"): _blocks("blocks", KV),
    ("starcoder2-7b", "production"): _blocks("blocks", ATTN_WHOLE),
    ("starcoder2-7b", "reduced"): _blocks("blocks", ATTN_WHOLE),
    ("phi3-medium-14b", "production"): _blocks("blocks", ATTN_WHOLE),
    ("phi3-medium-14b", "reduced"): _blocks("blocks", KV),
    ("yi-34b", "production"): _blocks("blocks", ATTN_WHOLE),
    ("yi-34b", "reduced"): _blocks("blocks", ATTN_WHOLE),
    ("kimi-k2-1t-a32b", "production"): _blocks("blocks", KV),
    ("kimi-k2-1t-a32b", "reduced"): _blocks("blocks", KV),
    ("qwen2-moe-a2.7b", "production"): {},
    ("qwen2-moe-a2.7b", "reduced"): {},
    ("xlstm-350m", "production"): XLSTM,
    ("xlstm-350m", "reduced"): {**XLSTM, "pairs.*.mlstm.w_gates": W},
    ("whisper-small", "production"): {
        **_blocks("enc_blocks", ATTN_WHOLE), **_blocks("dec_blocks",
                                                       ATTN_WHOLE),
        **_blocks("dec_blocks", {"xattn" + k[4:]: v
                                 for k, v in ATTN_WHOLE.items()})},
    ("whisper-small", "reduced"): {},
    ("internvl2-26b", "production"): _blocks("blocks", KV),
    ("internvl2-26b", "reduced"): _blocks("blocks", KV),
    ("zamba2-1.2b", "production"): _blocks("blocks", _mamba(4096, 64, 64)),
    ("zamba2-1.2b", "reduced"): _blocks("blocks", _mamba(256, 16, 4)),
}


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh_kind", ["production", "reduced"])
@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_tp_layout_departures_are_listed(arch, mesh_kind):
    """The port's layout equals the reference's `param_pspecs` but for the
    departures listed (`parallel/sharding.py`'s docstring says why):
    full widths on the (16, 16) production mesh, the reduced configs on
    (data 1, model 4). Every spec of the layout divides its shape."""
    if mesh_kind == "production":
        cfg, mesh = configs.get(arch), make_production_mesh()
    else:
        cfg, mesh = configs.get_reduced(arch), Mesh(("data", "model"), (1, 4))
    shapes = {n: tuple(p.shape) for n, p in
              LM(cfg, torch.device("meta")).named_parameters()}
    with parallel_ctx(mesh) as ctx:
        ref = param_pspecs(shapes, ctx)
        port, partial = tp_pspecs(shapes, cfg, ctx)
        tp = ctx.axis_size("tp")
    got = {}
    for n, shape in shapes.items():
        if _pad(port[n], len(shape)) != _pad(ref[n], len(shape)):
            got[re.sub(r"\.\d+\.", ".*.", n)] = port[n]
        for dim, e in zip(shape, port[n]):
            if isinstance(e, Segments):
                assert sum(e.sizes) == dim
                assert all(s % tp == 0 for s, c in zip(e.sizes, e.cut) if c)
            elif e is not None:
                assert dim % tp == 0, (n, shape, port[n])
    assert got == DEPARTURES[(arch, mesh_kind)]
    # under residual "tp" every replicated parameter's gradient is partial
    # but a replicated lm_head's; the norms always are
    assert all(partial[n] for n in shapes if n.split(".")[-1].startswith("ln"))
    assert not partial["lm_head"]
