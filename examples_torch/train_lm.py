"""Train a reduced qwen3 config end to end with checkpoint and resume.

The port of `examples/train_lm.py`, with ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions): 40 steps of the reduced
qwen3-8b at batch 8, sequence 64 and lr 3e-3 through
`repro_torch.launch.train`, a checkpoint every 20 steps, and the check
that the loss falls. Attention's forward and backward run B6 and B6b on
the card.

    PYTHONPATH=src python examples_torch/train_lm.py [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main

ARGS = dict(arch="qwen3-8b", steps=40, batch=8, seq=64, lr=3e-3, ckpt_every=20)


def train(device: str, ckpt_dir: str, *, arch=ARGS["arch"],
          steps=ARGS["steps"], batch=ARGS["batch"], seq=ARGS["seq"],
          lr=ARGS["lr"], ckpt_every=ARGS["ckpt_every"]) -> list[float]:
    """The example's run (its sizes by default): the losses."""
    return train_main([
        "--arch", arch, "--reduced", "--steps", str(steps),
        "--batch", str(batch), "--seq", str(seq), "--lr", str(lr),
        "--ckpt-dir", ckpt_dir, "--ckpt-every", str(ckpt_every),
        "--device", device,
    ])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        losses = train(args.device, d)
        assert losses[-1] < losses[0], "loss should decrease"
        print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{len(losses)} steps")
    return losses


if __name__ == "__main__":
    main()
