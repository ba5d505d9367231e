"""Run the port over several processes on the CPU, for the `test_torch_*`
files that hold its multi-rank code to the reference.

`run_world(world, jobs, tmp)` starts `world` processes of this file, each
one rank of a gloo process group (``init_method`` a file under `tmp`, so
that test workers never race for a port), one thread each. For each
``name: payload`` of `jobs`, in order, rank r calls
``_torch_dist_workers.<name>(rank, world, payload)``; the call returns,
for each rank in rank order, {name: what the function returned}. A rank
that fails, or a world that outlives `timeout` seconds, fails the caller
with the ranks' output; every process is stopped either way.

`run_jax(script, tmp, timeout)` runs a reference script in a subprocess
on 4 fake host devices (``XLA_FLAGS``), as the reference's own
distribution tests do, and returns what it pickled to ``OUT``;
`run_script` runs a script of the port's the same way, without them (a
census on torch's fake process group, which must not outlive its
process).

This file imports no JAX: the ranks load the port alone.
"""
from __future__ import annotations

import os
import pathlib
import pickle
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), OMP_NUM_THREADS="1",
        MKL_NUM_THREADS="1")
    env.update(extra or {})
    return env


def run_world(world: int, jobs: dict, tmp, timeout: float = 240.0,
              device: str = "cpu"):
    """With ``device="cuda"`` the group is NCCL, rank r on card r."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    inp = tmp / f"world{world}_in.pkl"
    inp.write_bytes(pickle.dumps(jobs))
    init = f"file://{tmp / f'world{world}_pg'}"
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"world{world}_r{r}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__)), device, str(r),
             str(world), init, str(inp), str(tmp / f"world{world}_r{r}.pkl")],
            cwd=ROOT, env=_env(), stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} outlived {timeout} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed:
            raise RuntimeError(f"a world of {world}: rank(s) {failed} failed")
    except Exception as e:
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {r} ---\n{log.read()[-6000:]}")
        raise AssertionError(f"{e}\n" + "\n".join(text)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [pickle.loads((tmp / f"world{world}_r{r}.pkl").read_bytes())
            for r in range(world)]


def run_jax(script: str, tmp, timeout: float = 600.0, devices: int = 4):
    """Run `script` with ``OUT`` (a path) defined, on `devices` fake CPU
    devices; returns the object it pickled to ``OUT``."""
    return run_script(script, tmp, timeout, {
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
        "JAX_PLATFORMS": "cpu"})


def run_script(script: str, tmp, timeout: float = 600.0,
               env: dict | None = None):
    """Run `script` with ``OUT`` (a path) defined in a subprocess; returns
    the object it pickled to ``OUT``."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    out = tmp / "reference.pkl"
    code = f"OUT = {str(out)!r}\n" + script
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=timeout, cwd=ROOT, env=_env(env))
    if r.returncode != 0 or not out.exists():
        raise AssertionError(f"script failed ({r.returncode}):\n"
                             f"{r.stdout[-4000:]}\n{r.stderr[-8000:]}")
    return pickle.loads(out.read_bytes())


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------

def _main(argv):
    device, rank, world, init, inp, out = argv
    import torch

    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed

    init_distributed(device, int(rank), int(world), init, local_rank=int(rank))
    import torch.distributed as dist

    try:
        jobs = pickle.loads(pathlib.Path(inp).read_bytes())
        import _torch_dist_workers

        result = {name: getattr(_torch_dist_workers, name)(int(rank),
                                                           int(world), payload)
                  for name, payload in jobs.items()}
        pathlib.Path(out).write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
