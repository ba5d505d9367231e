"""The census (`launch.dryrun`, `launch.step_stats`) on the CPU, held to
closed forms and to the reference's HLO counts.

The census runs a step on torch's fake process group, which stands in
for every `torch.distributed` call of the process it is left in, so each
census here runs in a subprocess of its own (`_torch_dist.run_script`):

- `step_stats` on a toy step, mirroring `tests/test_hlo_stats.py`: the
  matmuls' FLOPs exactly, an all-reduce counted twice, an all-gather by
  its gathered size, the call count;
- the reduced qwen3-8b's train, prefill and decode cells on a fake
  (data 2, model 2) mesh: the argument bytes equal the local shapes'
  bytes written from the config; the collective payloads equal
  `launch.specs.train_collectives`/`serve_collectives` converted to the
  reference's convention (on this mesh every group has 2 ranks); the
  projections' FLOPs equal their closed form; over depths 1, 2 and 3 the
  reference's extrapolation identity f(3) = f(1) + 2 (f(2) - f(1)) holds
  exactly (`layer_units`);
- qwen3-8b at full size, prefill_32k and decode_32k on the 16 x 16
  production mesh: status ok;
- against the reference: one reduced prefill cell on a one-device mesh,
  through `repro.launch.specs.build_cell` and `repro.launch.hlo_stats`
  (not `repro.launch.dryrun.run_cell`, which writes into the repo's
  results): the projections' FLOPs are equal, and the whole differs by
  the attention term alone. The port counts B6's causal work, 4 D per
  attended (query, key) pair, T (T + 1) / 2 pairs a head; the
  reference's XLA attention is two full T x T products, 4 D T^2 a head.
"""
import pytest

from _torch_dist import run_jax, run_script
from repro_torch import configs
from repro_torch.launch.dryrun import layer_units, probe_cfg
from repro_torch.launch.specs import serve_collectives, train_collectives
from repro_torch.models.config import ShapeSpec

B, T, SEQ = 4, 16, 16
PREFILL_T, PREFILL_B = 32, 2

PORT_SCRIPT = r"""
import dataclasses, pickle
import torch
from repro_torch import configs
from repro_torch.launch.dryrun import measure, probe_cfg, run_cell
from repro_torch.launch.mesh import census_mesh
from repro_torch.launch.step_stats import step_stats
from repro_torch.models.config import ShapeSpec
from repro_torch.parallel import all_gather, psum

out = {}
meta = torch.device("meta")
with census_mesh((2,), ("model",)) as mesh:
    def toy(a, b, x):
        d = a @ b
        for _ in range(10):
            x = x @ x
        ar = psum(d, "model", mesh)
        return all_gather(ar, "model", 1, mesh), x

    out["toy"] = step_stats(toy, torch.empty(128, 256, device=meta),
                            torch.empty(256, 64, device=meta),
                            torch.empty(8, 8, device=meta))

cfg = configs.get_reduced("qwen3-8b")
for kind, seq in (("train", T), ("prefill", T), ("decode", SEQ)):
    shape = ShapeSpec("s", seq, B, kind)
    for units in (1, 2, 3):
        with census_mesh((2, 2), ("data", "model")) as mesh:
            out[(kind, units)] = measure(probe_cfg(cfg, units), shape, mesh)
    if kind == "train":
        with census_mesh((2, 2), ("data", "model")) as mesh:
            out["train_noremat"] = measure(
                dataclasses.replace(cfg, remat="none"), shape, mesh)
with census_mesh((1,), ("model",)) as mesh:
    out["one_device"] = measure(cfg, ShapeSpec("p", PREFILL_T, PREFILL_B,
                                               "prefill"), mesh)
for shape in ("prefill_32k", "decode_32k"):
    out[shape] = run_cell("qwen3-8b", shape, False, results=False)

with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""

REF_SCRIPT = r"""
import pickle
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.launch.hlo_stats import hlo_stats
from repro.launch.specs import build_cell
from repro.models.config import ShapeSpec

cfg = configs.get_reduced("qwen3-8b")
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
cell = build_cell(cfg, ShapeSpec("p", PREFILL_T, PREFILL_B, "prefill"), mesh)
hlo = cell.fn.lower(*cell.abstract).compile().as_text()
with open(OUT, "wb") as f:
    pickle.dump(hlo_stats(hlo), f)
"""

CONSTS = f"T, SEQ, B, PREFILL_T, PREFILL_B = {T}, {SEQ}, {B}, {PREFILL_T}, " \
         f"{PREFILL_B}\n"


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    return run_script(CONSTS + PORT_SCRIPT,
                      tmp_path_factory.mktemp("census"), timeout=240)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_jax(CONSTS + REF_SCRIPT, tmp_path_factory.mktemp("census_ref"),
                   timeout=240)


def test_step_stats_dot_flops_exact(census):
    st = census["toy"]
    assert st["flops"] == 2 * 128 * 64 * 256 + 10 * 2 * 8 * 8 * 8
    assert st["n_dots"] == 11


def test_step_stats_collectives_in_the_reference_convention(census):
    c = census["toy"]["collectives"]
    assert c["all-reduce"] == 2 * 128 * 64 * 4     # payload x2
    assert c["all-gather"] == 128 * 128 * 4        # the gathered result
    assert c["reduce-scatter"] == c["all-to-all"] == 0
    assert c["count"] == 2


def test_step_stats_bytes_sane(census):
    st = census["toy"]
    assert st["bytes"] >= 128 * 256 * 4 + 256 * 64 * 4 + 128 * 64 * 4
    assert st["bytes_hbm"] <= st["bytes"]


def _cfg(units=None):
    cfg = configs.get_reduced("qwen3-8b")
    return cfg if units is None else probe_cfg(cfg, units)


def _param_bytes(cfg, M):
    """The dense model's local parameter bytes on a model axis of M
    (heads, kv heads, d_ff and the vocabulary cut, the norms whole)."""
    d, hd, H, Hkv, ff, V = (cfg.d_model, cfg.hd, cfg.heads_eff,
                            cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size)
    layer = 2 * d + d * H * hd // M + 2 * d * Hkv * hd // M + \
        H * hd // M * d + 3 * d * ff // M + 2 * hd
    return 4 * (2 * V // M * d + d + cfg.n_layers * layer)


@pytest.mark.parametrize("units", [1, 2, 3])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_are_the_local_shapes(census, kind, units):
    """Rank 0's arguments on (2, 2): its parameter blocks, and the train
    cell's AdamW moments (float32, ZeRO-1 cut over data where a dimension
    splits) and step, its token and target rows; the decode cell's cache
    rows of the kv heads it holds, its positions and tokens."""
    cfg = _cfg(units)
    M = D = 2
    got = census[(kind, units)]["memory"]["argument_size_in_bytes"]
    params = _param_bytes(cfg, M)
    b = B // D
    if kind == "train":
        want = params + 2 * params // D + 4 + 2 * 4 * b * T
    elif kind == "prefill":
        want = params + 4 * b * T
    else:
        kv = cfg.n_layers * b * SEQ * cfg.n_kv_heads // M * cfg.hd * 4
        want = params + 2 * kv + 4 * b + 4 * b
    assert got == want


def _convert(closed: dict, n: int) -> dict:
    """`counts`' input bytes in the reference's convention over groups of
    `n` ranks."""
    f = {"all_reduce": ("all-reduce", 2), "all_gather": ("all-gather", n),
         "reduce_scatter": ("reduce-scatter", 1 / n),
         "all_to_all": ("all-to-all", 1)}
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0}
    for kind, c in closed.items():
        name, factor = f[kind]
        out[name] += c["bytes"] * factor
    out["count"] = float(sum(c["calls"] for c in closed.values()))
    return out


@pytest.mark.parametrize("units", [1, 2, 3])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_collective_payloads_are_the_closed_form(census, kind, units):
    cfg = _cfg(units)
    if kind == "train":
        closed = train_collectives(cfg, ShapeSpec("s", T, B, kind), 2, 2)
    else:
        closed = serve_collectives(cfg, ShapeSpec(
            "s", T if kind == "prefill" else SEQ, B, kind), 2, 2)
    assert census[(kind, units)]["collectives"] == _convert(closed, 2)


def _projection_flops(cfg, n, M):
    """2 x the rows x the product's inner and outer widths, for every
    projection of a dense model on n token rows and a model axis of M."""
    d, hd, H, Hkv, ff, V = (cfg.d_model, cfg.hd, cfg.heads_eff,
                            cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size)
    layer = 2 * n * d * (2 * H * hd // M + 2 * Hkv * hd // M + 3 * ff // M)
    return cfg.n_layers * layer + 2 * n * d * V // M


@pytest.mark.parametrize("kind", ["train_noremat", "prefill", "decode"])
def test_projection_flops_are_the_closed_form(census, kind):
    """The matmuls' FLOPs (the total less the kernels' closed forms) are
    the projections': forward, and in training also the backward's two
    products each (remat off)."""
    cfg = _cfg()
    rec = census[kind] if kind == "train_noremat" else census[(kind, 2)]
    b = B // 2
    n = b * (1 if kind == "decode" else T)
    want = _projection_flops(cfg, n, 2) * (3 if kind == "train_noremat" else 1)
    kernels = sum(k["flops"] for k in rec["kernels"].values())
    assert rec["flops"] - kernels == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_layer_units_extrapolation_is_exact(census, kind):
    """The reference extrapolates its counts from 1- and 2-unit probes;
    the port counts every layer, and its counts obey that identity to the
    last unit over depths 1, 2 and 3."""
    assert layer_units(_cfg(3)) == 3
    f1, f2, f3 = (census[(kind, u)] for u in (1, 2, 3))

    def ext(key, get=lambda r, k: r[k]):
        return get(f1, key) + 2 * (get(f2, key) - get(f1, key))

    for key in ("flops", "bytes_accessed", "bytes_hbm", "n_dots"):
        assert f3[key] == ext(key), key
    for key in f3["collectives"]:
        assert f3["collectives"][key] == ext(
            key, lambda r, k: r["collectives"][k]), key
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        assert f3["memory"][key] == ext(key, lambda r, k: r["memory"][k])


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_full_size_cells_on_the_production_mesh(census, shape):
    rec = census[shape]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256 and rec["mode"] == shape.split("_")[0]
    main = rec["main"]
    assert main["flops"] > 0 and main["collectives"]["count"] > 0
    # qwen3-8b's 8 kv heads do not divide 16: decode attends a cache cut
    # by sequence, merged across the model axis
    if shape == "decode_32k":
        assert main["kernels"]["decode_attention"]["calls"] == 36


def test_prefill_flops_against_the_reference(census, reference):
    """One reduced prefill cell on a one-device mesh: the reference's
    HLO FLOPs are the port's but for the attention term, the full T x T
    products against B6's causal blocks."""
    cfg = _cfg()
    port = census["one_device"]
    kernels = port["kernels"]["flash_attention"]["flops"]
    n = PREFILL_B * PREFILL_T
    assert port["flops"] - kernels == _projection_flops(cfg, n, 1)
    H, hd = cfg.heads_eff, cfg.hd
    per_layer = PREFILL_B * H * hd
    full = 4 * per_layer * PREFILL_T ** 2 * cfg.n_layers
    causal = 4 * per_layer * PREFILL_T * (PREFILL_T + 1) // 2 * cfg.n_layers
    assert kernels == causal
    assert reference["flops"] == port["flops"] - causal + full
