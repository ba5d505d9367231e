"""The port's LM serving path against the JAX package's, on the reduced
configurations in float32: the reference's parameters carried across by
`lm_params_from_numpy`, then prefill logits, decode steps and caches, and
`examples/serve_lm.py`'s greedy loop compared, for every family (dense,
hybrid, moe, vlm, audio, ssm); plus the configuration registry and the
parameter counts for all ten architectures."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models.config import count_params as j_count_params
from repro.models.ssm import mamba2_init_state as j_mamba2_init_state
from repro.serve import make_serve_step as j_make_serve_step
from repro_torch import configs
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import decode_step, forward, init_cache, init_params, loss_fn
from repro_torch.models.config import count_params
from repro_torch.models.ssm import mamba2_init_state
from repro_torch.models.zoo import LM
from repro_torch.serve import make_prefill, make_serve_step

CPU = torch.device("cpu")
SERVED = ("qwen3-8b", "zamba2-1.2b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
          "internvl2-26b", "whisper-small", "xlstm-350m")
PORTED = SERVED + ("starcoder2-7b", "phi3-medium-14b", "yi-34b")
# the largest |port - reference| of the prefill logits (|logits| <= 4.6)
# measured on a CPU, per architecture; the test's tolerance is 1e-4, atol
# and rtol, and the gap may not grow tenfold past these
MEASURED_MAX = {"qwen3-8b": 2.44e-6, "zamba2-1.2b": 5.37e-6,
                "starcoder2-7b": 2.03e-6, "phi3-medium-14b": 4.36e-6,
                "yi-34b": 5.01e-6, "qwen2-moe-a2.7b": 4.41e-6,
                "kimi-k2-1t-a32b": 4.52e-6, "internvl2-26b": 4.26e-6,
                "whisper-small": 2.18e-6, "xlstm-350m": 3.76e-6}
# whisper's frames: more than its tokens, so cross attention has Tq != Tk
N_FRAMES_EXTRA = 8


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """Per served architecture: the reduced config and the reference's
    parameters (PRNGKey(0), as examples/serve_lm.py), in both packages."""
    out = {}
    for arch in PORTED:
        cfg = jconfigs.get_reduced(arch)
        jp = j_init_params(cfg, jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(_numpy_tree(jp), configs.get_reduced(arch),
                                  device=CPU)
        out[arch] = (cfg, jp, tp)
    return out


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T),
                                                dtype=np.int64).astype(np.int32)


def _batch(cfg, B, T, seed, n_embed=None):
    """A prefill batch as numpy: tokens (B, T), and for the vlm family
    patches (B, n_embed or num_patches, d), for the audio family frames (B,
    n_embed or T + N_FRAMES_EXTRA, d), normal draws of the same seed."""
    batch = {"tokens": _tokens(cfg, B, T, seed)}
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "vlm":
        n = cfg.num_patches if n_embed is None else n_embed
        batch["patches"] = rng.standard_normal((B, n, cfg.d_model))
    if cfg.family == "audio":
        n = T + N_FRAMES_EXTRA if n_embed is None else n_embed
        batch["frames"] = rng.standard_normal((B, n, cfg.d_model))
    return {k: v if k == "tokens" else v.astype(np.float32)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_reference(models, arch):
    cfg, jp, tp = models[arch]
    batch = _batch(cfg, 2, 16, 1)
    want = np.asarray(j_forward(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, cfg))
    got = make_prefill(configs.get_reduced(arch), device="cpu")(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    T = 16 + (cfg.num_patches if cfg.family == "vlm" else 0)
    assert got.shape == want.shape == (2, T, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(got - want).max() <= 10 * MEASURED_MAX[arch]


@pytest.mark.parametrize("arch", SERVED)
def test_decode_steps_match_reference(models, arch):
    """8 decode steps from the reference's own empty cache: logits at every
    step and every cache entry after the last agree. (The reference's step
    is jitted, as examples/serve_lm.py runs it.)"""
    cfg, jp, tp = models[arch]
    tcfg = configs.get_reduced(arch)
    B, steps = 2, 8
    toks = _tokens(cfg, B, steps, 2)
    jcache = j_init_cache(cfg, B, steps + 1)
    tcache = lm_cache_from_numpy(_numpy_tree(jcache), tcfg, device=CPU)
    jstep = jax.jit(j_decode_step, static_argnums=3)
    for t in range(steps):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]), cfg)
        tl, tcache = decode_step(tp, tcache, torch.from_numpy(toks[:, t]), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    assert set(tcache) == set(jcache)
    for key, want in _numpy_tree(jcache).items():
        np.testing.assert_allclose(tcache[key].numpy(), want, atol=1e-4,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("arch", SERVED)
def test_decode_matches_own_forward(arch):
    """Token-by-token decode reproduces the port's own prefill logits, as
    tests/test_models.py::test_decode_matches_forward holds the reference,
    where the two compute the same function: MoE at a capacity factor that
    drops no slot (forward and decode route different numbers of tokens),
    the VLM with no patches, whisper with zero frames (the encoder's
    memory is then exactly 0, as the cache's is), xLSTM chunked against
    its recurrence."""
    cfg = configs.get_reduced(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    params = init_params(cfg, seed=1, device="cpu")
    B, T = 2, 8
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, B, T, 1, n_embed=0).items()}
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((B, T, cfg.d_model))
    toks = batch["tokens"]
    full = forward(params, batch, cfg).numpy()
    cache = init_cache(cfg, B, T + 1, device="cpu")
    got = []
    for t in range(T):
        logits, cache = decode_step(params, cache, toks[:, t], cfg)
        got.append(logits.numpy())
    np.testing.assert_allclose(np.stack(got, axis=1), full, atol=2e-3, rtol=2e-3)
    assert cache["pos"].tolist() == [T] * B


@pytest.mark.parametrize("arch", SERVED)
def test_serve_lm_loop_gives_reference_tokens(models, arch):
    """examples/serve_lm.py's loop: an 8-token prompt teacher-forced into
    the cache, then 24 greedy tokens; the port's equal the reference's."""
    cfg, jp, tp = models[arch]
    tcfg = configs.get_reduced(arch)
    B, n_prompt, n_gen = 2, 8, 24
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (B, n_prompt)).astype(np.int32)

    def run(step, cache, as_array):
        tok = as_array(prompt[:, 0])
        for t in range(1, n_prompt):
            _, cache = step(cache, tok)
            tok = as_array(prompt[:, t])
        out = []
        for _ in range(n_gen):
            tok, cache = step(cache, tok)
            out.append(np.asarray(tok))
        return np.stack(out, 1)

    jstep = jax.jit(j_make_serve_step(cfg))
    want = run(lambda c, t: jstep(jp, c, t),
               j_init_cache(cfg, B, n_prompt + n_gen + 1), jnp.asarray)
    tstep = make_serve_step(tcfg, device="cpu")
    got = run(lambda c, t: tstep(tp, c, t),
              init_cache(tcfg, B, n_prompt + n_gen + 1, device="cpu"),
              torch.from_numpy)
    assert got.shape == (B, n_gen)
    np.testing.assert_array_equal(got, want)


def test_sampling_step():
    """temperature > 0 with a generator samples (torch's draws, not the
    reference's); the same seed gives the same tokens, and without a
    generator the step is greedy."""
    cfg = configs.get_reduced("qwen3-8b")
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.tensor([3, 7], dtype=torch.int32)
    greedy = make_serve_step(cfg, device="cpu")
    sample = make_serve_step(cfg, temperature=0.7, device="cpu")

    def draw(step, **kw):
        return step(params, init_cache(cfg, 2, 4, device="cpu"), tokens,
                    **kw)[0]

    a = draw(sample, generator=torch.Generator().manual_seed(5))
    b = draw(sample, generator=torch.Generator().manual_seed(5))
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    assert torch.equal(draw(sample), draw(greedy))


def test_mamba2_state_matches_reference():
    cfg = configs.get_reduced("zamba2-1.2b")
    want = j_mamba2_init_state(3, cfg.d_model, jconfigs.get_reduced(
        "zamba2-1.2b"), jnp.float32)
    got = mamba2_init_state(3, cfg.d_model, cfg, torch.float32, CPU)
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape
        assert str(got[key].dtype).split(".")[1] == str(w.dtype)


@pytest.mark.parametrize("arch", list(jconfigs.all_arch_ids()))
def test_configs_match_reference(arch):
    """Every field of the full and the reduced configuration, and the
    parameter counts, equal the reference's for all ten architectures."""
    for getter in ("get", "get_reduced"):
        want = getattr(jconfigs, getter)(arch)
        got = getattr(configs, getter)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.hd, got.heads_eff, got.expert_slots) == (
            want.hd, want.heads_eff, want.expert_slots)
        for active in (False, True):
            assert count_params(got, active) == j_count_params(want, active)
    assert configs.all_arch_ids() == jconfigs.all_arch_ids()


def test_full_width_configs():
    q, z = configs.get("qwen3-8b"), configs.get("zamba2-1.2b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.hd, q.d_ff,
            q.vocab_size, q.qk_norm) == (36, 4096, 32, 8, 128, 12288, 151936,
                                         True)
    assert (z.n_layers, z.d_model, z.n_heads, z.n_kv_heads, z.hd, z.ssm_state,
            z.shared_attn_every, z.vocab_size) == (38, 2048, 32, 32, 64, 64, 6,
                                                   32000)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen2-moe-a2.7b",
                                  "whisper-small", "internvl2-26b",
                                  "xlstm-350m"])
def test_loss_fn_waits_for_training(arch):
    """Named for what it held while the port did not train (that
    `loss_fn` refused); it now holds `loss_fn` of every family to the
    reference's loss on its own synthetic batch (rtol 1e-5; the gradients
    are held in tests/test_torch_train.py), and serving's cache as
    before."""
    from repro.models import loss_fn as j_loss_fn
    from repro.models.config import ShapeSpec
    from repro.train.data import make_batch as j_make_batch

    cfg = configs.get_reduced(arch)
    assert init_cache(cfg, 1, 4, device="cpu")["pos"].tolist() == [0]
    jcfg = jconfigs.get_reduced(arch)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    batch = _numpy_tree(j_make_batch(jcfg, ShapeSpec("t", 24, 2, "train"), 0))
    params = lm_params_from_numpy(_numpy_tree(jp), cfg, device=CPU)
    with torch.no_grad():
        got = loss_fn(params, {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in batch.items()}, cfg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(j_loss_fn(jp, batch, jcfg)),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", list(jconfigs.all_arch_ids()))
def test_param_count_matches_reference_on_meta(arch):
    """The port's LM of the full-width config, built on the meta device
    (no memory), holds exactly as many parameters, of the same shapes, as
    the reference's `init_params` tree (`jax.eval_shape`, no memory
    either). `count_params` is the reference's estimate: equal to the tree
    for the dense, vlm and kimi configs, but it counts n_experts where
    the tree holds expert_slots, and estimates the ssm, audio and hybrid
    blocks."""
    cfg = jconfigs.get(arch)
    shapes = jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0)))
    want = sorted((jax.tree_util.keystr(path), leaf.shape) for path, leaf in
                  jax.tree_util.tree_flatten_with_path(shapes)[0])
    model = LM(configs.get(arch), torch.device("meta"))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s)) for _, s in want)
    assert sorted(tuple(p.shape) for p in model.parameters()) == sorted(
        (s[1:] if _stacked(k) else s) for k, s in want for _ in range(
            _layers(k, cfg)))
    if (cfg.family in ("dense", "vlm", "moe") and not cfg.qk_norm
            and cfg.expert_slots == cfg.n_experts):
        assert n == j_count_params(cfg)


def _stacked(key: str) -> bool:
    return any(key.startswith(f"['{n}']") for n in (
        "blocks", "enc_blocks", "dec_blocks", "pairs"))


def _layers(key: str, cfg) -> int:
    """How many port parameters one reference leaf stands for: its layers."""
    if not _stacked(key):
        return 1
    if key.startswith("['enc_blocks']"):
        return cfg.encoder_layers
    if key.startswith("['pairs']"):
        return cfg.n_layers // 2
    return cfg.n_layers


def test_converter_checks_every_leaf(models):
    cfg, jp, _ = models["qwen3-8b"]
    tcfg = configs.get_reduced("qwen3-8b")
    tree = _numpy_tree(jp)
    bad = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head: shape"):
        lm_params_from_numpy(bad, tcfg, device=CPU)
    bad = dict(tree, ln_f=tree["ln_f"].astype(np.float64))
    with pytest.raises(TypeError, match="ln_f: dtype"):
        lm_params_from_numpy(bad, tcfg, device=CPU)
    bad = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(bad, tcfg, device=CPU)
    blocks = dict(tree["blocks"], ln1=tree["blocks"]["ln1"][:1])
    with pytest.raises(ValueError, match="stacked layers"):
        lm_params_from_numpy(dict(tree, blocks=blocks), tcfg, device=CPU)


# per family: a leaf of its own tree cast to float64, a key dropped from a
# nested holder, and a cache entry of its own cut short
NEW_TREES = {
    "qwen2-moe-a2.7b": (("blocks", "moe", "w_router"),
                        ("blocks", "moe", "shared", "w_down"), "k"),
    "kimi-k2-1t-a32b": (("blocks", "moe", "w_gate"), ("blocks", "moe", "w_up"),
                        "v"),
    "internvl2-26b": (("blocks", "mlp", "w_gate"), ("blocks", "attn", "w_o"),
                      "k"),
    "whisper-small": (("dec_blocks", "xattn", "w_q"), ("dec_blocks", "ln_x"),
                      "xk"),
    "xlstm-350m": (("pairs", "mlstm", "w_gates"), ("pairs", "slstm", "w_h"),
                   "mlstm"),
}


def _edit(tree, path, fn):
    """A copy of `tree` with the leaf or holder at `path` replaced by
    fn(it), or removed where fn returns None."""
    out = dict(tree)
    if len(path) == 1:
        new = fn(out[path[0]])
        if new is None:
            del out[path[0]]
        else:
            out[path[0]] = new
        return out
    out[path[0]] = _edit(tree[path[0]], path[1:], fn)
    return out


@pytest.mark.parametrize("arch", list(NEW_TREES))
def test_converter_checks_new_family_trees(models, arch):
    """The MoE, VLM, audio and xLSTM trees and caches go through the same
    checks: a leaf of another dtype, a missing key, a cache entry of
    another shape each raise, naming the leaf."""
    cfg, jp, _ = models[arch]
    tcfg = configs.get_reduced(arch)
    tree = _numpy_tree(jp)
    typed, dropped, cache_key = NEW_TREES[arch]
    with pytest.raises(TypeError, match=typed[-1] + ": dtype"):
        lm_params_from_numpy(_edit(tree, typed, lambda a: a.astype(np.float64)),
                             tcfg, device=CPU)
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_numpy(_edit(tree, dropped, lambda a: None), tcfg,
                             device=CPU)
    cache = _numpy_tree(j_init_cache(cfg, 2, 6))
    assert set(lm_cache_from_numpy(cache, tcfg, device=CPU)) == set(cache)
    bad = dict(cache, **{cache_key: cache[cache_key][:, :1]})
    with pytest.raises(ValueError, match=f"{cache_key}: shape"):
        lm_cache_from_numpy(bad, tcfg, device=CPU)
