"""The port's MoE layer (`repro_torch.models.moe`) against
`repro.models.moe` on the CPU: the router's top-k with its tie rule, the
capacity, the dispatch indices and `moe_ref`, dropless and dropping, on
expert weights perturbed slot by slot, so that a token sent to another
expert than the reference's shows. Float32 throughout; tolerances are
stated per test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe as tmoe

ARCHS = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
# the largest |port - reference| of moe_ref's output (|y| <= 4.8) measured
# on a CPU over the cases below was 1.2e-6; the tolerance is 1e-5, atol and
# rtol
TOL = 1e-5


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **kw),
            dataclasses.replace(configs.get_reduced(arch), **kw))


def _perturbed(jcfg, tcfg, seed):
    """The reference's `init_moe` (every slot the same draw), each slot then
    perturbed by its own noise; the same numbers in both packages."""
    tree = jax.tree_util.tree_map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(seed), jcfg.d_model, jcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for key in ("w_gate", "w_up", "w_down"):
        w = tree[key]
        tree[key] = (w + 0.5 * np.abs(w).mean()
                     * rng.standard_normal(w.shape)).astype(np.float32)
    p = tmoe.MoE(tcfg.d_model, tcfg, torch.float32, torch.device("cpu"))
    with torch.no_grad():
        for name, w in p.named_parameters():
            node = tree
            for part in name.split("."):
                node = node[part]
            w.copy_(torch.from_numpy(np.array(node)))
    return jax.tree_util.tree_map(jnp.asarray, tree), p


def _x(cfg, N, seed):
    x = np.random.default_rng(seed).standard_normal((1, N, cfg.d_model))
    return x.astype(np.float32)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_router_topk_matches_reference(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((64, 32)).astype(np.float32)
    w = rng.standard_normal((32, 60)).astype(np.float32)
    jw, js = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), k)
    tw, ts = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k)
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)


def test_router_topk_ties_take_the_lower_index():
    """Equal probabilities: `jax.lax.top_k` takes the lower index first, and
    so does the port. A zero router ties every expert; a router whose
    columns repeat ties them in pairs."""
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    base = np.random.default_rng(1).standard_normal((8, 6)).astype(np.float32)
    for w in (np.zeros((8, 12), np.float32), np.repeat(base, 2, axis=1),
              np.tile(base, (1, 2))):
        for k in (2, 3, 5):
            _, js = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), k)
            _, ts = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _, ts = tmoe.router_topk(torch.from_numpy(x), torch.zeros((8, 12)), 3)
    assert (ts.numpy() == [0, 1, 2]).all()


@pytest.mark.parametrize("n_slots,n_buckets,cf", [
    (32, 60, 1.25), (16384, 60, 1.25), (8, 6, 1.0), (5, 7, 2.0), (12, 4, 1.0),
    (64, 384, 1.25)])
def test_capacity_matches_reference(n_slots, n_buckets, cf):
    assert tmoe._capacity(n_slots, n_buckets, cf) == \
        jmoe._capacity(n_slots, n_buckets, cf)


@pytest.mark.parametrize("n,buckets,capacity", [(64, 8, 5), (300, 64, 6),
                                                (32, 64, 1), (7, 3, 100)])
def test_dispatch_indices_match_reference(n, buckets, capacity):
    """The stable sort, positions and kept slots, on routings with many
    collisions (few buckets in use)."""
    sel = np.random.default_rng(n).integers(0, min(buckets, 5), n).astype(
        np.int32)
    want = jmoe._dispatch_indices(jnp.asarray(sel), buckets, capacity)
    got = tmoe._dispatch_indices(torch.from_numpy(sel), buckets, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("regime", ["default", "dropless", "dropping"])
def test_moe_ref_matches_reference(arch, regime):
    """moe_ref on perturbed slots: at the config's capacity factor, at one
    that drops nothing and at 1.0 (slots over capacity dropped: checked
    that some are). Also at a decode batch of 8 tokens."""
    cf = {"default": None, "dropless": 64.0, "dropping": 1.0}[regime]
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _perturbed(jcfg, tcfg, 3)
    for N in (96, 8):
        x = _x(tcfg, N, N)
        want = np.asarray(jmoe.moe_ref(jnp.asarray(x), jp, jcfg))
        got = tmoe.moe_ref(torch.from_numpy(x), tp, tcfg).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        _, sel = tmoe.router_topk(torch.from_numpy(x[0]), tp.w_router,
                                  tcfg.experts_per_tok)
        C = tmoe._capacity(N * tcfg.experts_per_tok, tcfg.n_experts,
                           tcfg.capacity_factor)
        kept = tmoe._dispatch_indices(sel.reshape(-1), tcfg.expert_slots, C)[3]
        if regime == "dropless":
            assert bool(kept.all())
        if regime == "dropping":
            assert not bool(kept.all())


def test_a_misrouted_slot_would_show():
    """The slots differ after perturbation: swapping two slots' weights
    moves the output far past the tolerance, so the parity above would
    catch a token sent to the wrong expert."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    _, tp = _perturbed(jcfg, tcfg, 3)
    x = torch.from_numpy(_x(tcfg, 96, 96))
    y = tmoe.moe_ref(x, tp, tcfg)
    with torch.no_grad():
        for w in (tp.w_gate, tp.w_up, tp.w_down):
            w[[0, 1]] = w[[1, 0]]
    assert float((tmoe.moe_ref(x, tp, tcfg) - y).abs().max()) > 100 * TOL


def test_init_makes_every_expert_identical():
    """The reference's init repeats one draw over every slot; so does the
    port's seeded init (its numbers are torch's)."""
    cfg = configs.get_reduced("qwen2-moe-a2.7b")
    p = tmoe.init_moe(tmoe.MoE(cfg.d_model, cfg, torch.float32,
                               torch.device("cpu")), torch.Generator().manual_seed(0))
    jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg.d_model,
                       jconfigs.get_reduced("qwen2-moe-a2.7b"), jnp.float32)
    for key in ("w_gate", "w_up", "w_down"):
        w, jw = getattr(p, key), np.asarray(jp[key])
        assert w.shape == jw.shape and w.shape[0] == cfg.expert_slots
        assert torch.equal(w, w[:1].expand_as(w))
        assert (jw == jw[:1]).all()
    assert p.w_router.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_bitwise_repeatable(dtype):
    """Two runs of moe_ref give the same bits (dispatch is a plain indexed
    write, the combine adds a token's slots in a fixed order)."""
    _, tcfg = _cfgs("kimi-k2-1t-a32b")
    _, tp = _perturbed(*_cfgs("kimi-k2-1t-a32b"), 5)
    tp = tp.to(dtype)
    x = torch.from_numpy(_x(tcfg, 200, 1)).to(dtype)
    assert torch.equal(tmoe.moe_ref(x, tp, tcfg), tmoe.moe_ref(x, tp, tcfg))


def test_without_shared_experts():
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", n_shared_experts=0)
    jp, tp = _perturbed(jcfg, tcfg, 4)
    assert tp.shared is None and "shared" not in jp
    x = _x(tcfg, 40, 2)
    np.testing.assert_allclose(
        tmoe.moe_ref(torch.from_numpy(x), tp, tcfg).numpy(),
        np.asarray(jmoe.moe_ref(jnp.asarray(x), jp, jcfg)), atol=TOL, rtol=TOL)
