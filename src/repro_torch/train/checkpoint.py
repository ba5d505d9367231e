"""Checkpointing with atomic commit, resume, and restore onto any device.

Port of `repro.train.checkpoint`. Layout (one directory per step):

    ckpt_dir/
      step_00000123/
        manifest.json        # step, and per leaf: name, file, shape, dtype
        leaf_00000.npy ...   # one .npy per leaf (host copy)
      LATEST                 # atomically-renamed pointer file

Leaves are named by the train state's keys, not by their order: each
parameter by its `named_parameters` name, the moments as ``m.<name>`` and
``v.<name>``, the optimizer's count as ``step`` (`state_tensors`).
bfloat16 has no numpy type, so a bfloat16 leaf is saved as its 16 bits
(uint16) and the manifest says so (``"stored": "bf16_bits"``): it comes
back without loss.

Fault-tolerance contract, as the reference's:
  * `save` writes into `step_xxxx.tmp` and renames only after every leaf +
    manifest hit disk — a crash mid-save never corrupts the latest
    checkpoint (restart resumes from the previous LATEST).
  * `restore` copies each leaf into the template state's tensors, on
    whatever device they live: a checkpoint written from the CPU restores
    onto the card.
  * `Checkpointer.save_async` copies the state to the host on the caller's
    thread (a consistent snapshot), then writes on a background thread
    (one outstanding save; joins before starting another) and keeps the
    newest `keep` steps.

A state cut over a process-group mesh (it holds a ``placement``,
`repro_torch.train.optimizer.Placement`) is saved whole: every rank
all-gathers each leaf by its spec (the collectives need them all) and
rank 0 writes the files, in the same format, so a one-card checkpoint
and a W-rank checkpoint of the same state are the same files. `restore`
reads each leaf whole and cuts this rank's block by the template's
placement, so a run resumes on another world size (the elastic restart,
as the reference's ``restore(..., shardings)``).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch

__all__ = ["Checkpointer", "latest_step", "read_leaves", "restore", "save",
           "save_async", "state_tensors"]


def state_tensors(state: dict) -> dict:
    """{leaf name: tensor} of a train state {"params": nn.Module, "opt":
    {"m", "v", "step"}}: parameter names, then ``m.*``, ``v.*`` and
    ``step``. A flat dict of tensors (or arrays) is returned as it is."""
    if "params" not in state:
        return dict(state)
    out = dict(state["params"].named_parameters())
    opt = state.get("opt")
    if opt is not None:
        out.update({f"m.{k}": v for k, v in opt["m"].items()})
        out.update({f"v.{k}": v for k, v in opt["v"].items()})
        out["step"] = opt["step"]
    return out


def _to_host(t) -> tuple[np.ndarray, str, str]:
    """(a host copy to save, dtype name, how it is stored). Always a copy:
    a CPU tensor's numpy view would follow later in-place updates."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).to("cpu", copy=True).numpy()
            return bits.view(np.uint16), "bfloat16", "bf16_bits"
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype), "npy"
    arr = np.array(t, copy=True)
    return arr, str(arr.dtype), "npy"


def _snapshot(state) -> dict | None:
    """{leaf name: host copy}; for a state cut over a mesh, the gathered
    leaves on rank 0 and None on the other ranks."""
    leaves = state_tensors(state)
    pl = state.get("placement") if isinstance(state, dict) else None
    if pl is None:
        return {name: _to_host(t) for name, t in leaves.items()}
    from ..parallel.sharding import gather_full

    specs = pl.leaf_specs()
    writer = pl.mesh.axis_index(pl.mesh.axis_names) == 0
    out = {}
    for name, t in leaves.items():
        full = gather_full(t, specs[name], pl.mesh)
        if writer:
            out[name] = _to_host(full)
        del full
    return out if writer else None


def _write(ckpt_dir, step: int, snap: dict) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    metas = []
    for i, (name, (arr, dtype, stored)) in enumerate(snap.items()):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        metas.append({"name": name, "file": fname, "shape": list(arr.shape),
                      "dtype": dtype, "stored": stored})
    manifest = {"step": step, "n_leaves": len(metas), "leaves": metas}
    (tmp / "manifest.json").write_text(json.dumps(manifest))

    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic commit
    latest_tmp = ckpt_dir / "LATEST.tmp"
    latest_tmp.write_text(str(step))
    latest_tmp.rename(ckpt_dir / "LATEST")
    return final


def save(ckpt_dir, step: int, state) -> pathlib.Path:
    """Write `state` (a train state or a flat dict of tensors) as step
    `step` and point LATEST at it; returns the step's directory (every
    rank of a cut state calls it; rank 0 writes)."""
    snap = _snapshot(state)
    final = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    return final if snap is None else _write(ckpt_dir, step, snap)


def latest_step(ckpt_dir) -> Optional[int]:
    p = pathlib.Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def _load_leaf(d: pathlib.Path, meta: dict) -> torch.Tensor:
    arr = np.load(d / meta["file"])
    if meta["stored"] == "bf16_bits":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def read_leaves(ckpt_dir, step: int, names=None) -> dict:
    """{leaf name: host tensor} of step `step`, for the leaves `names`
    (default: all), each whole and in its saved type."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return {m["name"]: _load_leaf(d, m) for m in manifest["leaves"]
            if names is None or m["name"] in names}


def restore(ckpt_dir, step: Optional[int], template):
    """Copy step `step` (None: LATEST) into `template`'s tensors (a train
    state or a flat dict of tensors), each on its own device and in its
    own type; returns the template. Every leaf's name must match the
    template's, and its shape the template's (for a state cut over a
    mesh: its shape cut by the template's placement)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no LATEST under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = state_tensors(template)
    pl = template.get("placement") if isinstance(template, dict) else None
    specs = pl.leaf_specs() if pl is not None else {}
    names = [m["name"] for m in manifest["leaves"]]
    if set(names) != set(leaves):
        raise ValueError(f"checkpoint leaves differ from the state's: "
                         f"{sorted(set(names) ^ set(leaves))[:8]}")
    with torch.no_grad():
        for meta in manifest["leaves"]:
            dst = leaves[meta["name"]]
            src = _load_leaf(d, meta)
            if pl is not None:
                from ..parallel.sharding import local_shard

                src = local_shard(src, specs[meta["name"]], pl.mesh)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{meta['name']}: shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return template


class Checkpointer:
    """Async checkpointer with a single outstanding background save."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, state):
        self.wait()
        # the host copy on the caller thread (consistent snapshot), IO
        # off-thread; of a cut state, only rank 0 writes
        snap = _snapshot(state)
        if snap is None:
            return

        def work():
            _write(self.dir, step, snap)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)


def save_async(ckpt: Checkpointer, step: int, state):
    ckpt.save_async(step, state)
