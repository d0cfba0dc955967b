"""End-to-end training on the PyTorch/CUDA port: train a ~130M-param LM for
a few hundred steps.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]   # the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 3

Uses the full training substrate (deterministic pipeline, AdamW, async
checkpointing, crash-restart): a run resumes from the latest checkpoint
under ``--ckpt-dir``, by default ``build/train_lm_torch/`` of the
checkout (git-ignored).
"""
import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import repro_torch.configs as configs
from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig

# ~130M params: 8 layers x d768 + 32k vocab embeddings
LM_130M = ModelConfig(
    name="lm-130m", family="dense", n_layers=8, d_model=768,
    n_heads=12, n_kv_heads=4, head_dim=64, d_ff=3072, vocab=32000,
    activation="swiglu", remat=False)

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "train_lm_torch"


def main(argv: Optional[Sequence[str]] = None,
         stats_out: Optional[Dict] = None) -> str:
    """Train; returns the line it printed itself (``train``'s step log
    goes to stdout only).  ``stats_out``, when given, gets the losses
    (``"losses"``) and ``train``'s own stats (each step's seconds, the
    start step)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    # register the config so the launcher can find it
    class _Mod:  # noqa: N801
        CONFIG = LM_130M
        SMOKE = LM_130M
    configs.ARCHS["lm-130m"] = _Mod
    stats = {}
    losses, _ = train("lm-130m", smoke=False, n_steps=args.steps,
                      batch=8, seq=256, ckpt_dir=args.ckpt_dir,
                      ckpt_every=50, device=args.device, stats_out=stats)
    if stats_out is not None:
        stats_out.update(stats, losses=losses)
    line = (f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
            f"over {len(losses)} steps" if losses else
            "no step to run: the checkpoint is at or past --steps")
    print(line)
    return line


if __name__ == "__main__":
    main()
