"""The port's training slice against the JAX package's, on the CPU: the
loss and its gradients for all ten reduced configs, one train step with
and without microbatches, the optimizer and its schedule, the synthetic
data, the sharding specs, the elastic helpers, checkpoints and the
launcher's resume and SIGTERM. Inputs are made with numpy from a seed and handed to
both packages; the reference's parameters are carried across by
`repro_torch.convert`.

Tolerances, each measured on a CPU first:
- loss: rtol 1e-5 (measured at most 2.4e-7 relative).
- gradients, per leaf: rtol 1e-4 plus atol 1e-5 x the leaf's largest
  |gradient| (measured at most 5.8e-6 x the largest, xlstm-350m). A plain
  atol of 1e-6 does not hold: the largest entries reach 1-10, and float32
  sums taken in another order than XLA's differ by a few of their ulps.
- a train step's m and v: rtol 1e-4 plus atol 1e-5 x the leaf's largest
  magnitude; its parameters the same plus 0.05 x lr (a first AdamW step
  is lr g / (|g| + eps): measured 0.017 x lr on 1 weight of 8192);
  grad_norm rtol 1e-5, lr rtol 1e-6.
"""
import dataclasses
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models.config import ShapeSpec as JShapeSpec
from repro.parallel import param_pspecs as j_param_pspecs
from repro.parallel import parallel_ctx as j_parallel_ctx
from repro.train import AdamW as JAdamW
from repro.train import cosine_schedule as j_cosine_schedule
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro.train.data import make_batch as j_make_batch
from repro.train.elastic import StragglerMonitor as JStragglerMonitor
from repro.train.elastic import plan_remesh as j_plan_remesh
from repro.train.optimizer import zero1_pspecs as j_zero1_pspecs
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_production_mesh
from repro_torch.launch.train import main as train_main
from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ShapeSpec
from repro_torch.parallel import constrain, param_pspecs, parallel_ctx
from repro_torch.parallel.sharding import default_rules
from repro_torch.train import AdamW, cosine_schedule, init_state, make_train_step
from repro_torch.train.checkpoint import (
    Checkpointer,
    latest_step,
    restore,
    save,
    state_tensors,
)
from repro_torch.train.data import SyntheticTokens, make_batch
from repro_torch.train.elastic import StragglerMonitor, plan_remesh
from repro_torch.train.optimizer import zero1_pspecs

CPU = torch.device("cpu")
ARCHS = tuple(jconfigs.all_arch_ids())
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5
# a first AdamW step moves each weight by lr g / (|g| + eps) (plus decay):
# where |g| is within a few ulps of its rounding noise the step's size
# moves by a fraction of lr (measured: 0.017 lr on 1 of 8192 weights)
PARAM_ATOL_OF_LR = 0.05


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _perturb_experts(tree, seed):
    """Each MoE slot's weights drawn apart (the reference's init repeats
    one draw over the slots), the same numbers for both packages."""
    rng = np.random.default_rng(seed)
    moe = tree["blocks"]["moe"]
    for key in ("w_gate", "w_up", "w_down"):
        w = moe[key]
        moe[key] = (w + 0.5 * np.abs(w).mean()
                    * rng.standard_normal(w.shape)).astype(np.float32)
    return tree


def _reference_params(arch, seed=0):
    jcfg = jconfigs.get_reduced(arch)
    tree = _np_tree(j_init_params(jcfg, jax.random.PRNGKey(seed)))
    if jcfg.family == "moe":
        tree = _perturb_experts(tree, seed + 1)
    return jcfg, tree


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _assert_leaf_close(got: torch.Tensor, want: torch.Tensor, name: str,
                       extra_atol: float = 0.0):
    want = want.detach().float()
    atol = GRAD_ATOL_OF_MAX * float(want.abs().max()) + extra_atol
    np.testing.assert_allclose(got.detach().float().numpy(), want.numpy(),
                               rtol=GRAD_RTOL, atol=atol, err_msg=name)


def _by_name(tree, cfg):
    """A reference pytree shaped like the parameters (gradients, moments),
    keyed by the port's parameter names."""
    holder = lm_params_from_numpy(_np_tree(tree), cfg, device=CPU)
    return dict(holder.named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """`loss_fn` and its gradients against `jax.value_and_grad(repro.models.
    loss_fn)` from the same weights and the reference's batch (2 x 24)."""
    jcfg, tree = _reference_params(arch)
    tcfg = configs.get_reduced(arch)
    batch = _np_tree(j_make_batch(jcfg, JShapeSpec("t", 24, 2, "train"), 0))
    jl, jg = jax.value_and_grad(j_loss_fn)(_j_tree(tree), _j_tree(batch), jcfg)
    params = lm_params_from_numpy(tree, tcfg, device=CPU)
    params.requires_grad_(True)
    loss = loss_fn(params, _torch_batch(batch), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    want = _by_name(jg, tcfg)
    for name, p in params.named_parameters():
        _assert_leaf_close(p.grad, want[name], name)


def test_vlm_loss_scores_only_the_text_and_masks_negative_targets():
    """The vlm family's loss covers the text tail only; targets below 0
    count for nothing, as in the reference."""
    jcfg, tree = _reference_params("internvl2-26b")
    tcfg = configs.get_reduced("internvl2-26b")
    batch = _np_tree(j_make_batch(jcfg, JShapeSpec("t", 40, 2, "train"), 3))
    batch["targets"] = batch["targets"].copy()
    batch["targets"][:, ::3] = -1
    params = lm_params_from_numpy(tree, tcfg, device=CPU)
    with torch.no_grad():
        got = loss_fn(params, _torch_batch(batch), tcfg).item()
    want = float(j_loss_fn(_j_tree(tree), _j_tree(batch), jcfg))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert batch["targets"].shape[1] < tcfg.num_patches + batch["tokens"].shape[1]


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b", "whisper-small",
                                  "qwen2-moe-a2.7b", "xlstm-350m"])
def test_remat_gives_the_gradients_of_no_remat(arch, remat):
    """Rematerialised layers (recomputed in the backward, B6 and B8
    included) give bitwise the gradients of keeping every activation."""
    cfg = configs.get_reduced(arch)
    params = init_params(cfg, seed=1, device=CPU)
    params.requires_grad_(True)
    batch = make_batch(cfg, ShapeSpec("t", 20, 2, "train"), 1, device=CPU)
    grads = {}
    for mode in ("none", remat):
        params.zero_grad(set_to_none=True)
        loss_fn(params, batch, dataclasses.replace(cfg, remat=mode)).backward()
        grads[mode] = [p.grad.clone() for p in params.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat]))


def test_serving_builds_no_graph():
    """Parameters come without gradients, and the serving entry points run
    under no_grad even for a model whose gradients are on."""
    from repro_torch.serve import make_prefill

    cfg = configs.get_reduced("qwen3-8b")
    params = init_params(cfg, seed=0, device=CPU)
    assert not any(p.requires_grad for p in params.parameters())
    params.requires_grad_(True)
    batch = make_batch(cfg, ShapeSpec("t", 8, 1, "train"), 0, device=CPU)
    logits = make_prefill(cfg, device=CPU)(params, {"tokens": batch["tokens"]})
    assert logits.grad_fn is None and not logits.requires_grad


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 10, 100), (3e-3, 0, 40),
                                               (1e-2, 5, 5)])
def test_cosine_schedule_matches_reference(peak, warmup, total):
    j_lr, t_lr = j_cosine_schedule(peak, warmup, total), cosine_schedule(
        peak, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(float(t_lr(torch.tensor(step))),
                                   float(j_lr(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    """One AdamW update alone on random bf16 and float32 parameters, from
    non-zero moments at step 4: clipped (norm above 1) and not."""
    rng = np.random.default_rng(7)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: np.abs(rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    kw = dict(lr=cosine_schedule(1e-2, 2, 10), clip_norm=clip)
    jopt = JAdamW(**{**kw, "lr": j_cosine_schedule(1e-2, 2, 10)})
    jp = {k: jnp.asarray(a).astype(jnp.bfloat16 if k == "a" else jnp.float32)
          for k, a in params.items()}
    jst = {"m": _j_tree(m), "v": _j_tree(v), "step": jnp.asarray(4, jnp.int32)}
    jnew, jstate, jmet = jopt.update(_j_tree(grads), jst, jp)

    module = torch.nn.Module()
    for k, a in params.items():
        t = torch.from_numpy(a.copy())
        module.register_parameter(k, torch.nn.Parameter(
            t.to(torch.bfloat16) if k == "a" else t))
    tst = {"m": {k: torch.from_numpy(a.copy()) for k, a in m.items()},
           "v": {k: torch.from_numpy(a.copy()) for k, a in v.items()},
           "step": torch.tensor(4, dtype=torch.int32)}
    _, tstate, tmet = AdamW(**kw).update(
        {k: torch.from_numpy(a) for k, a in grads.items()}, tst, module)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 5
    for k in shapes:
        got = getattr(module, k).detach()
        want = np.asarray(jnew[k].astype(jnp.float32))
        if k == "a":   # bf16: the same rounding of a float32 update
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tstate["m"][k].numpy(),
                                   np.asarray(jstate["m"][k]), rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(tstate["v"][k].numpy(),
                                   np.asarray(jstate["v"][k]), rtol=1e-5,
                                   atol=1e-8)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One `make_train_step` step of the reduced qwen3-8b (batch 4 x 16)
    from the reference's `init_state`, carried across by
    `train_state_from_numpy`: loss, grad_norm, lr, updated parameters, m,
    v and the step count."""
    arch = "qwen3-8b"
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    sched = dict(peak_lr=3e-3, warmup=2, total=10)
    jopt = JAdamW(lr=j_cosine_schedule(**sched))
    jstate = j_init_state(jcfg, jax.random.PRNGKey(0), jopt)
    state = train_state_from_numpy(_np_tree(jstate), tcfg, device=CPU)
    batch = _np_tree(j_make_batch(jcfg, JShapeSpec("t", 16, 4, "train"), 0))
    jnew, jmet = jax.jit(j_make_train_step(jcfg, jopt, microbatches))(
        jstate, _j_tree(batch))
    opt = AdamW(lr=cosine_schedule(**sched))
    state, met = make_train_step(tcfg, opt, microbatches)(state,
                                                          _torch_batch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)
    assert int(state["opt"]["step"]) == 1
    want_p = _by_name(jnew["params"], tcfg)
    lr = float(met["lr"])
    for name, p in state["params"].named_parameters():
        _assert_leaf_close(p, want_p[name], name, extra_atol=PARAM_ATOL_OF_LR * lr)
    f32 = dataclasses.replace(tcfg, dtype="float32")
    for key in ("m", "v"):
        want = _by_name(jnew["opt"][key], f32)
        for name, t in state["opt"][key].items():
            _assert_leaf_close(t, want[name], f"{key}.{name}")


def test_microbatches_split_the_first_axis_in_order():
    """Two microbatches of 2 add their float32 gradients in order: the
    same as summing each half's gradients by hand, divided by 2."""
    cfg = configs.get_reduced("zamba2-1.2b")
    batch = make_batch(cfg, ShapeSpec("t", 12, 4, "train"), 0, device=CPU)
    grads = []
    for half in (slice(0, 2), slice(2, 4)):
        params = init_params(cfg, seed=2, device=CPU)
        params.requires_grad_(True)
        loss_fn(params, {k: v[half] for k, v in batch.items()}, cfg).backward()
        grads.append({n: p.grad.float() for n, p in params.named_parameters()})
    opt = AdamW(lr=0.0, weight_decay=0.0)
    state = init_state(cfg, 2, opt, device=CPU)
    seen = {}
    real_update = opt.update

    def spy(g, st, params):
        seen.update(g)
        return real_update(g, st, params)

    opt.update = spy
    make_train_step(cfg, opt, 2)(state, batch)
    for name, g in seen.items():
        assert torch.equal(g, (grads[0][name] + grads[1][name]) / 2), name


# ---------------------------------------------------------------------------
# data, specs, elastic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_reference(arch):
    jcfg, tcfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    for step, seed in ((0, 0), (5, 3)):
        want = j_make_batch(jcfg, JShapeSpec("t", 48, 3, "train"), step, seed)
        got = make_batch(tcfg, ShapeSpec("t", 48, 3, "train"), step, seed,
                         device=CPU)
        assert set(got) == set(want)
        for k in want:
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_synthetic_tokens_resume_at_a_step():
    cfg = configs.get_reduced("qwen3-8b")
    shape = ShapeSpec("t", 16, 2, "train")
    a = iter(SyntheticTokens(cfg, shape, 4, "cpu"))
    b = iter(SyntheticTokens(cfg, shape, 4, "cpu", start_step=2))
    first = [next(a) for _ in range(4)]
    assert all(torch.equal(first[2][k], v) for k, v in next(b).items())


def test_plan_remesh_matches_reference():
    for n in range(1, 70):
        for prefer in (1, 2, 3, 4, 8, 16):
            assert plan_remesh(n, prefer) == j_plan_remesh(n, prefer)


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(0)
    for factor, alpha, evict in ((3.0, 0.1, 5), (1.5, 0.3, 2), (1.1, 0.5, 1)):
        t, j = StragglerMonitor(factor, alpha, evict), JStragglerMonitor(
            factor, alpha, evict)
        times = rng.lognormal(0.0, 0.8, 200)
        for s in times:
            assert t.observe(float(s)) == j.observe(float(s))
            assert (t.flags, t.consecutive, t.should_evict) == (
                j.flags, j.consecutive, j.should_evict)


def _norm_spec(spec):
    """A spec as a tuple with trailing Nones dropped."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _reference_specs(jcfg, mesh_shape, axes):
    """The reference's param specs on an abstract mesh, keyed by pytree
    path, each stacked leaf's without its leading layer axis; and its
    ZeRO-1 rule applied to those per-layer specs and shapes (on a stacked
    leaf the rule may take the layer axis, which the port's separate
    layer tensors do not have)."""
    mesh = AbstractMesh(mesh_shape, axes)
    shapes = jax.eval_shape(lambda: j_init_params(jcfg, jax.random.PRNGKey(0)))
    stacked = ("blocks", "enc_blocks", "dec_blocks", "pairs")
    P = jax.sharding.PartitionSpec

    def per_layer(path, x):
        cut = 1 if getattr(path[0], "key", None) in stacked else 0
        if isinstance(x, P):
            return P(*tuple(x)[cut:])
        return jax.ShapeDtypeStruct(x.shape[cut:], x.dtype)

    with j_parallel_ctx(mesh) as ctx:
        specs = jax.tree_util.tree_map_with_path(
            per_layer, j_param_pspecs(shapes, ctx),
            is_leaf=lambda x: isinstance(x, P))
        layer_shapes = jax.tree_util.tree_map_with_path(per_layer, shapes)
        zspecs = j_zero1_pspecs(specs, layer_shapes, ctx)
    out = {}
    flat = [jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, P))[0]
        for t in (specs, zspecs, layer_shapes)]
    for (path, s), (_, z), (_, leaf) in zip(*flat):
        keys = tuple(getattr(k, "key", str(k)) for k in path)
        out[keys] = (_norm_spec(s), _norm_spec(z), leaf.shape)
    return out


@pytest.mark.parametrize("mesh_shape,axes", [
    ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
    ((4, 2), ("data", "model"))])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_reference(arch, mesh_shape, axes):
    """`param_pspecs` and `zero1_pspecs` on the full-width config (shapes
    only: the meta device) against the reference's on an `AbstractMesh`,
    which needs no devices: equal to the reference's param specs without
    the layer axis, and to its ZeRO-1 rule on each layer's own spec and
    shape."""
    jcfg, tcfg = jconfigs.get(arch), configs.get(arch)
    want = _reference_specs(jcfg, mesh_shape, axes)
    mesh = Mesh(axes, mesh_shape)
    shapes = {n: p.shape for n, p in init_params_meta(tcfg).named_parameters()}
    with parallel_ctx(mesh) as ctx:
        specs = param_pspecs(shapes, ctx)
        zspecs = zero1_pspecs(specs, shapes, ctx)
    seen = set()
    for name, shape in shapes.items():
        key = tuple(p for p in name.split(".") if not p.isdigit())
        w_spec, w_zero, w_shape = want[key]
        assert tuple(shape) == tuple(w_shape), name
        assert _norm_spec(specs[name]) == w_spec, name
        assert _norm_spec(zspecs[name]) == w_zero, name
        seen.add(key)
    assert seen == set(want)


def init_params_meta(cfg):
    from repro_torch.models.zoo import LM

    return LM(cfg, torch.device("meta"))


def test_one_device_leaves_specs_alone():
    """No mesh, or a mesh of one device: every parameter replicated,
    ZeRO-1 adds nothing, `constrain` is the identity."""
    cfg = configs.get_reduced("qwen2-moe-a2.7b")
    params = init_params(cfg, device=CPU)
    specs = param_pspecs(params)
    assert set(specs.values()) == {()}
    mesh = make_local_mesh(1, 1, "cpu")
    with parallel_ctx(mesh, default_rules(mesh)) as ctx:
        assert not ctx.active
        specs = param_pspecs(params, ctx)
        shapes = {n: p.shape for n, p in params.named_parameters()}
        assert zero1_pspecs(specs, shapes, ctx) == specs
        x = torch.ones(2, 3)
        assert constrain(x, "dp", None) is x
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    with pytest.raises(ValueError, match="torch sees"):
        make_local_mesh(2, 1, "cpu")


# ---------------------------------------------------------------------------
# checkpoints and the launcher
# ---------------------------------------------------------------------------

def _bf16_state():
    cfg = dataclasses.replace(configs.get_reduced("zamba2-1.2b"),
                              dtype="bfloat16")
    state = init_state(cfg, 3, AdamW(), device=CPU)
    with torch.no_grad():
        for name, t in state_tensors(state).items():
            if t.is_floating_point():
                t.add_(torch.randn(t.shape, generator=torch.Generator()
                                   .manual_seed(len(name))).to(t.dtype))
    state["opt"]["step"].fill_(7)
    return cfg, state


def test_checkpoint_round_trip_is_exact(tmp_path):
    """Every leaf (bf16 parameters by their bits, float32 moments, the
    int32 step) comes back equal, under the state's own names."""
    cfg, state = _bf16_state()
    d = save(tmp_path, 7, state)
    manifest = json.loads((d / "manifest.json").read_text())
    names = [m["name"] for m in manifest["leaves"]]
    assert names[-1] == "step" and "m.tok_emb" in names and "v.ln_f" in names
    assert {m["stored"] for m in manifest["leaves"]} == {"bf16_bits", "npy"}
    fresh = init_state(cfg, 9, AdamW(), device=CPU)
    restore(tmp_path, None, fresh)
    want, got = state_tensors(state), state_tensors(fresh)
    assert all(torch.equal(want[k], got[k]) and want[k].dtype == got[k].dtype
               for k in want)
    assert latest_step(tmp_path) == 7


def test_checkpoint_commit_is_atomic(tmp_path):
    """A save that dies before its rename leaves LATEST on the last
    complete step, which restores; a later save replaces the leftover."""
    cfg, state = _bf16_state()
    save(tmp_path, 2, state)
    (tmp_path / "step_00000004.tmp").mkdir()
    (tmp_path / "step_00000004.tmp" / "leaf_00000.npy").write_bytes(b"torn")
    assert latest_step(tmp_path) == 2
    restore(tmp_path, None, init_state(cfg, 1, AdamW(), device=CPU))
    save(tmp_path, 4, state)
    assert latest_step(tmp_path) == 4
    assert not (tmp_path / "step_00000004.tmp").exists()
    with pytest.raises(ValueError, match="leaves differ"):
        restore(tmp_path, 4, {"x": torch.zeros(2)})


def test_async_checkpointer_keeps_the_newest_three(tmp_path):
    """Saves run on a background thread from a snapshot taken at the call:
    a change to the state after the call does not reach the file."""
    cfg, state = _bf16_state()
    ck = Checkpointer(tmp_path, keep=3)
    ln_f = state["params"].ln_f
    for step in (1, 2, 3, 4, 5):
        with torch.no_grad():
            ln_f.fill_(step)
        ck.save_async(step, state)
        with torch.no_grad():
            ln_f.fill_(-1.0)
    ck.wait()
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    fresh = init_state(cfg, 1, AdamW(), device=CPU)
    restore(tmp_path, 3, fresh)
    assert torch.equal(fresh["params"].ln_f, torch.full_like(ln_f, 3.0))


def _train_args(d, steps=4):
    return ["--arch", "zamba2-1.2b", "--reduced", "--steps", str(steps),
            "--batch", "4", "--seq", "24", "--lr", "3e-3",
            "--microbatches", "2", "--ckpt-dir", str(d), "--ckpt-every", "2",
            "--device", "cpu"]


def test_launch_train_resumes_bitwise(tmp_path):
    """`launch.train` for 4 steps, checkpoints at 2 and 4; a second run
    from the step-2 checkpoint repeats steps 2 and 3 to the last bit."""
    report = {}
    full = train_main(_train_args(tmp_path / "a"), report=report)
    assert len(full) == 4 and all(np.isfinite(full))
    assert report["start"] == 0 and len(report["step_seconds"]) == 4
    save_dir = tmp_path / "b"
    train_main(_train_args(save_dir, steps=2))
    assert latest_step(save_dir) == 2
    resumed = train_main(_train_args(save_dir), report=report)
    assert report["start"] == 2
    assert resumed == full[2:]


def test_launch_train_checkpoints_on_sigterm(tmp_path, monkeypatch):
    """SIGTERM during a step: the run finishes the step, checkpoints it
    and stops."""
    import repro_torch.launch.train as lt

    orig = lt.make_train_step

    def patched(cfg, opt, mb):
        step = orig(cfg, opt, mb)

        def run(state, batch):
            signal.raise_signal(signal.SIGTERM)   # arrives during the step
            return step(state, batch)
        return run

    monkeypatch.setattr(lt, "make_train_step", patched)
    losses = train_main(_train_args(tmp_path, steps=50))
    assert len(losses) == 1 and latest_step(tmp_path) == 1


def test_train_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("qwen3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(cfg, 0, AdamW())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, ShapeSpec("t", 8, 2, "train"), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--reduced", "--steps", "1"])
