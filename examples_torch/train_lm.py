"""End-to-end training example: the paper's 340M hybrid (SWA/MoBA) recipe
at CPU-runnable scale, with checkpointing + auto-resume.

    PYTHONPATH=src python examples_torch/train_lm.py --device cpu  # smoke
    PYTHONPATH=src python examples_torch/train_lm.py --full        # card

Compares MoBA against the dense baseline over a few hundred steps on the
synthetic Markov corpus — the Table 1 protocol in miniature.  A rerun
resumes from the checkpoint directory; one that finds every step done
prints the restored step.
"""
import argparse
import os
import sys
import tempfile

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_root, "src"))

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="use the real 340M config (slow on CPU)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "moba_train_example_torch"),
        help="checkpoints; a rerun resumes from here "
             "(default %(default)s)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    print("== MoBA (B=16, k=2 smoke) ==")
    _, moba_losses = train("moba-340m", steps=args.steps, batch=4,
                           seq=256, smoke=not args.full,
                           attn_backend="sparse", lr=3e-3,
                           ckpt_dir=args.ckpt_dir, resume="auto",
                           save_interval=25, device=args.device)
    if moba_losses:
        print(f"final loss: {moba_losses[-1]:.4f} "
              f"(start {moba_losses[0]:.4f})")
    else:
        step = CheckpointManager(args.ckpt_dir).latest_step()
        print(f"nothing to train: {args.ckpt_dir} holds step {step} of "
              f"{args.steps}")
    return moba_losses


if __name__ == "__main__":
    main()
