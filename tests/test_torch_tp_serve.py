"""Serving under tensor parallelism on the CPU: prefill and decode over
(data, model) gloo meshes, against the reference's one-device serving
path and the port's.

The port runs over gloo process groups of 1, 2 and 4 processes
(`_torch_dist.run_world`, the `tp_serve` worker); the reference in one
subprocess (`_torch_dist.run_jax`). Every family's reduced float32 config
(qwen3-8b dense, yi-34b dense with 7 heads and 1 kv head, qwen2-moe-a2.7b,
internvl2-26b, whisper-small, xlstm-350m, zamba2-1.2b) serves a batch of
4: prefill logits of 8 tokens (internvl2 16 patches before them, whisper
16 frames), then 8 decode steps on forced tokens from an empty cache of
16 positions. On (1, 2), (2, 2) and (1, 4) every logit is within 1e-4 of
the reference's one-device `forward`/`decode_step` with the same argmax,
and the cache gathered whole by `tp_cache_pspecs` within 1e-4 of the
reference's. At (1, 1) and (2, 1), a model axis of 1, each rank's logits
and cache equal the port's one-device serving of its own sequences
bitwise.

The three cuts of the KV cache (`parallel.sharding.kv_cache_cut`):
qwen3-8b-reduced's 2 kv heads are cut by heads on (1, 2) and by sequence
on (1, 4), where 4 positions a rank put the decode steps across the
ranks' edges (positions 3, 4, 5) and leave ranks 2 and 3 with nothing
valid for the first 8 steps; yi-34b-reduced's attention runs whole over a
sequence-cut cache; a cache of 18 positions, which 4 does not divide, is
replicated.

MoE: the reference's decode routes through `moe_ref` over the whole batch,
whatever the mesh, and the port's decode through `moe_sharded` at the
capacities that give `moe_ref`'s drops (`transformer._moe`). Its
prefill, like the reference's under a mesh, runs `moe_sharded` at its
own capacities, so qwen2-moe's prefill is held to the reference's
forward on the same mesh. A case at capacity factor 0.5 over a batch of
8 makes the capacity 2 slots an expert, where 16 slots go to 6 experts:
drops are certain. The experts are perturbed apart, as in
`tests/test_torch_moe.py`. The MoE cases are not held bitwise at a model
axis of 1: expert parallelism over the data axis computes the experts on
other ranks' buffers, and the one-device prefill drops at another
capacity.
"""
import numpy as np
import pytest

from _torch_dist import run_jax, run_world
from repro_torch import configs
from repro_torch.launch.specs import serve_collectives
from repro_torch.models.config import ShapeSpec

TOL = 1e-4
B, T, STEPS, MAX_LEN = 4, 8, 8, 16

ARCHS = ["qwen3-8b", "yi-34b", "qwen2-moe-a2.7b", "internvl2-26b",
         "whisper-small", "xlstm-350m", "zamba2-1.2b"]
MOE = "qwen2-moe-a2.7b"
# the extra reference cases: (key, arch, replace, batch, max_len)
EXTRA = [("qwen3-8b@18", "qwen3-8b", {}, B, 18),
         ("moe-tight", MOE, {"capacity_factor": 0.5}, 8, MAX_LEN)]

JAX_SCRIPT = r"""
import dataclasses, pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.models import decode_step, forward, init_cache, init_params
from repro.parallel import parallel_ctx
from repro.parallel.sharding import default_rules

np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
jnp_tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)


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


def batch_of(cfg, seed, b):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, T)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (0.5 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = (0.5 * rng.standard_normal(
            (b, 2 * T, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, STEPS)).astype(np.int32)
    return batch, toks


def serve(cfg, params, batch, toks, max_len):
    jp = jnp_tree(params)
    prefill = np.asarray(jax.jit(forward, static_argnums=2)(
        jp, jnp_tree(batch), cfg))
    cache = init_cache(cfg, toks.shape[0], max_len)
    step = jax.jit(decode_step, static_argnums=3)
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t]), cfg)
        logits.append(np.asarray(lg))
    return {"prefill": prefill, "decode": np.stack(logits),
            "cache": np_tree(cache)}


out = {}
cases = [(a, a, {}, B, MAX_LEN) for a in ARCHS] + EXTRA
for i, (key, arch, replace, b, max_len) in enumerate(cases):
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                              **replace)
    params = np_tree(init_params(cfg, jax.random.PRNGKey(30 + i)))
    if cfg.family == "moe":
        params = perturb(params, 30 + i)
    batch, toks = batch_of(cfg, 30 + i, b)
    rec = {"params": params, "batch": batch, "tokens": toks,
           "max_len": max_len, "replace": replace, "arch": arch,
           "one": serve(cfg, params, batch, toks, max_len)}
    if arch == MOE and not replace:
        # the reference's prefill under a mesh routes through moe_sharded
        rec["dist"] = {}
        for shape in ((1, 2), (2, 2), (1, 4)):
            mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]])
                        .reshape(shape), ("data", "model"))
            rules = default_rules(mesh)

            def fwd(p, bt):
                with parallel_ctx(mesh, rules):
                    return forward(p, bt, cfg)

            with parallel_ctx(mesh, rules):
                rec["dist"][shape] = np.asarray(jax.jit(fwd)(
                    jnp_tree(params), jnp_tree(batch)))
    out[key] = rec

with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""

MESHES = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}


def _b7_payload():
    """A cache of 16 positions (4 kv heads, 8 query heads, D 16) and
    lengths that leave the second half (on 2 ranks) or the last ranks (on
    4) with nothing: 0, 1, 4, 7, 8, 9, 15 and 16."""
    rng = np.random.default_rng(27)
    B, Hq, Hkv, S, D = 8, 8, 4, 16, 16
    f32 = np.float32
    return {"q": rng.standard_normal((B, Hq, D)).astype(f32),
            "k": rng.standard_normal((B, S, Hkv, D)).astype(f32),
            "v": rng.standard_normal((B, S, Hkv, D)).astype(f32),
            "lengths": {"edges": np.array([0, 1, 4, 7, 8, 9, 15, 16],
                                          np.int32),
                        "first_half": np.array([1, 2, 3, 4, 5, 6, 7, 8],
                                               np.int32)}}


@pytest.fixture(scope="module")
def tmp_mod(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_serve")


@pytest.fixture(scope="module")
def reference(tmp_mod):
    head = (f"ARCHS = {ARCHS!r}\nMOE = {MOE!r}\nEXTRA = {EXTRA!r}\n"
            f"B, T, STEPS, MAX_LEN = {B}, {T}, {STEPS}, {MAX_LEN}\n")
    return run_jax(head + JAX_SCRIPT, tmp_mod / "jax")


def _case(ref, key, mesh, one_device):
    r = ref[key]
    return {"arch": r["arch"], "params": r["params"], "batch": r["batch"],
            "tokens": r["tokens"], "max_len": r["max_len"],
            "replace": r["replace"], "mesh": mesh, "one_device": one_device}


@pytest.fixture(scope="module")
def worlds(reference, tmp_mod):
    out = {}
    for world, meshes in MESHES.items():
        jobs = {}
        for mesh in meshes:
            for key in ARCHS:
                jobs[f"{key}@{mesh}"] = _case(reference, key, mesh,
                                              mesh[1] == 1)
        if world == 4:
            jobs["qwen3-8b@18@(1, 4)"] = _case(reference, "qwen3-8b@18",
                                               (1, 4), False)
        if world >= 2:
            for mesh in ((2, 1), (2, 2)):
                if mesh in meshes:
                    jobs[f"moe-tight@{mesh}"] = _case(reference, "moe-tight",
                                                      mesh, False)
        extra = {"b7_merge": _b7_payload()} if world > 1 else {}
        out[world] = run_world(world, {"tp_serve": jobs, **extra},
                               tmp_mod / f"w{world}", timeout=300)
    return out


def _ranks(worlds, key, mesh):
    world = mesh[0] * mesh[1]
    return [r["tp_serve"][f"{key}@{mesh}"] for r in worlds[world]]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=f"{what}: argmax")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference(worlds, reference, arch, mesh):
    """Prefill logits, 8 forced decode steps' logits and the cache after
    them, on every rank, against the reference's one-device serving (MoE
    prefill: against the reference's forward on the same mesh)."""
    ref = reference[arch]
    want_prefill = ref["dist"][mesh] if arch == MOE else ref["one"]["prefill"]
    for r, got in enumerate(_ranks(worlds, arch, mesh)):
        _close(got["prefill"], want_prefill, f"{arch} {mesh} rank {r} prefill")
        _close(got["decode"], ref["one"]["decode"],
               f"{arch} {mesh} rank {r} decode")
        assert set(got["cache"]) == set(ref["one"]["cache"])
        for k, want in ref["one"]["cache"].items():
            np.testing.assert_allclose(got["cache"][k], want, atol=TOL,
                                       rtol=TOL, err_msg=f"{arch} {mesh} {k}")


@pytest.mark.parametrize("mesh", [(1, 1), (2, 1)])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != MOE])
def test_model_axis_of_one_is_the_one_device_path(worlds, arch, mesh):
    """At a model axis of 1 every collective is a copy: each rank's
    prefill and decode logits and its cache equal the port's one-device
    serving of its own sequences, bit for bit."""
    for r, got in enumerate(_ranks(worlds, arch, mesh)):
        one, local = got["one_device"], got["local"]
        np.testing.assert_array_equal(local["prefill"], one["prefill"])
        np.testing.assert_array_equal(local["decode"], one["decode"])
        for k, want in one["cache"].items():
            np.testing.assert_array_equal(local["cache"][k], want,
                                          err_msg=f"{arch} {mesh} r{r} {k}")


@pytest.mark.parametrize("key,mesh,cut", [
    ("qwen3-8b", (1, 2), "heads"), ("qwen3-8b", (1, 4), "seq"),
    ("yi-34b", (1, 2), "seq"), ("yi-34b", (1, 4), "seq"),
    ("qwen3-8b@18", (1, 4), "whole")])
def test_kv_cache_cuts(worlds, reference, key, mesh, cut):
    """The cache's cut on each mesh, and the decode against the reference:
    by heads, by sequence (4 positions a rank on (1, 4): the 8 steps
    write positions 0-7, across the edges at 3 | 4 and past them, while
    ranks 2 and 3 hold no valid position and weigh nothing in the merge),
    and replicated where 4 does not divide 18 positions."""
    ref = reference[key]
    want_spec = {"heads": (None, None, None, "model", None),
                 "seq": (None, None, "model", None, None),
                 "whole": (None, None, None, None, None)}[cut]
    for got in _ranks(worlds, key, mesh):
        assert got["cuts"]["k"] == want_spec
        _close(got["decode"], ref["one"]["decode"], f"{key} {mesh}")
        np.testing.assert_allclose(got["cache"]["k"], ref["one"]["cache"]["k"],
                                   atol=TOL, rtol=TOL)
    if cut == "seq" and mesh == (1, 4):
        s_loc = ref["max_len"] // 4
        assert STEPS > s_loc + 1                  # steps at S_loc - 1, S_loc, + 1
        assert STEPS <= 2 * s_loc                 # ranks 2, 3: nothing valid


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_moe_decode_at_tight_capacity(worlds, reference, mesh):
    """qwen2-moe-reduced at capacity factor 0.5, a batch of 8 over 2 data
    ranks: each rank routes 4 tokens, and the decode drops the slots the
    reference's `moe_ref` drops over all 8 (capacity 2 an expert)."""
    ref = reference["moe-tight"]
    cfg = configs.get_reduced(MOE)
    k, E = cfg.experts_per_tok, cfg.n_experts
    assert -(-8 * k * 0.5 // E) < 8 * k / E       # fewer places than slots
    for got in _ranks(worlds, "moe-tight", mesh):
        _close(got["decode"], ref["one"]["decode"], f"moe-tight {mesh}")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_runs_the_closed_form_collectives(worlds, reference, kind,
                                                  mesh):
    """The reduced qwen3-8b's prefill and first decode step run the
    collectives `launch.specs.serve_collectives` writes from the config,
    call for call and byte for byte (on (1, 4) the decode over a cache cut
    by sequence)."""
    cfg = configs.get_reduced("qwen3-8b")
    shape = ShapeSpec("s", T if kind == "prefill" else MAX_LEN, B, kind)
    want = serve_collectives(cfg, shape, *mesh)
    for got in _ranks(worlds, "qwen3-8b", mesh):
        assert got[f"{kind}_counts"] == want


# ---------------------------------------------------------------------------
# B7's statistics and the merge across ranks
# ---------------------------------------------------------------------------

def test_b7_statistics_are_the_log_sum_exp():
    """The plain version's (M, L): M + log L is the float64 log-sum-exp of
    each row's scaled, masked scores (M the maximum up to the splits'
    rescaling, which M + log L absorbs); an empty row gives (-1e30, 0);
    `out` is the same with or without them."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_plain

    p = _b7_payload()
    q, k, v = (torch.from_numpy(p[n]) for n in ("q", "k", "v"))
    lens = torch.from_numpy(p["lengths"]["edges"])
    out, st = decode_attention_plain(q, k, v, lens, stats=True)
    assert torch.equal(out, decode_attention_plain(q, k, v, lens))
    assert st.dtype == torch.float32 and st.shape == (8, 8, 2)
    D, g = q.shape[-1], q.shape[1] // k.shape[2]
    s = np.einsum("bhd,bshd->bhs", p["q"].astype(np.float64),
                  np.repeat(p["k"].astype(np.float64), g, axis=2)) * D ** -0.5
    st = st.numpy().astype(np.float64)
    for b, n in enumerate(p["lengths"]["edges"]):
        if n == 0:
            assert np.all(st[b, :, 0] == np.float32(-1e30))
            assert np.all(st[b, :, 1] == 0)
            continue
        row = s[b, :, :n]
        m = row.max(-1)
        want = m + np.log(np.exp(row - m[:, None]).sum(-1))
        np.testing.assert_allclose(st[b, :, 0] + np.log(st[b, :, 1]), want,
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(st[b, :, 0], m, rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("lengths", ["edges", "first_half"])
def test_sequence_cut_merge_is_one_pass(worlds, world, lengths):
    """`decode_attention_merged` over a cache cut in 2 or 4 by sequence
    (ranks with no valid position among them: length 0 and lengths inside
    the first block) gives on every rank the one-pass plain version over
    the whole cache, within 1e-6 in float32."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_plain

    p = _b7_payload()
    want = decode_attention_plain(*(torch.from_numpy(p[n])
                                    for n in ("q", "k", "v")),
                                  torch.from_numpy(p["lengths"][lengths]))
    for got in worlds[world]:
        np.testing.assert_allclose(got["b7_merge"][lengths], want.numpy(),
                                   rtol=0, atol=1e-6)
