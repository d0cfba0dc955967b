"""End-to-end training (the reference's ``launch/train.py``).

    python -m repro_torch.launch.train --arch granite-3-2b --smoke \\
        --steps 4 --device cpu
    python -m repro_torch.launch.train --arch granite-3-2b --steps 6 \\
        --batch 8 --seq 1024 --ckpt-dir /tmp/ckpt

Wires the training path together: config -> model -> the deterministic
token pipeline -> AdamW -> the train step -> async checkpoints ->
restart (the latest checkpoint restored and the data stream rewound to
it).  Runs on the card unless ``--device cpu``.  The VLM trains on zero
``prefix_embeds`` of ``frontend_tokens`` rows, the stubbed frontend, as
the reference's ``train`` does.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..checkpoint import manager as ckpt
from ..configs import ARCHS, get_config
from ..data.pipeline import TokenPipeline
from ..device import resolve
from ..models import model
from ..models.config import ModelConfig
from ..optim import adamw
from . import steps as steps_mod


def _batch(pipe: TokenPipeline, cfg: ModelConfig,
           dev: torch.device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v).to(dev)
           for k, v in pipe.next_batch().items()}
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.zeros(
            (pipe.global_batch, cfg.frontend_tokens, cfg.d_model),
            dtype=torch.float32, device=dev)
    return out


def train(arch: str, smoke: bool, n_steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str], ckpt_every: int = 10,
          compress_grads: bool = False, log_every: int = 5,
          seed: int = 0, device=None, stats_out: Optional[Dict] = None
          ) -> Tuple[List[float], Dict[str, torch.Tensor]]:
    """Train ``arch`` from ``model.init_params(cfg, seed)`` for steps
    ``start .. n_steps - 1``, where ``start`` is the latest checkpoint's
    step under ``ckpt_dir`` (0 without one; a restored checkpoint
    replaces the weights); returns the losses of the steps run and the
    parameters.  ``stats_out``, when given, gets each step's wall
    seconds (``"step_s"``, synchronized) and the start step."""
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke)
    opt_cfg = adamw.AdamWConfig(total_steps=n_steps,
                                warmup_steps=max(1, n_steps // 10),
                                compress_grads=compress_grads)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=batch, seq_len=seq,
                         seed=seed, n_codebooks=cfg.n_codebooks)
    params = model.init_params(cfg, seed, dev)
    opt_state = adamw.init(params, opt_cfg)
    start = 0

    writer = None
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            print(f"[restore] step {last} from {ckpt_dir}")
            params, opt_state, data_state = ckpt.restore(
                ckpt_dir, last, (params, opt_state, pipe.state_dict()))
            pipe.load_state_dict(data_state)
            start = last
        writer = ckpt.AsyncCheckpointer(ckpt_dir)

    step_fn = steps_mod.make_train_step(cfg, opt_cfg)
    losses, step_s = [], []
    t0 = time.time()
    try:
        for step in range(start, n_steps):
            ts = time.perf_counter()
            loss, params, opt_state = step_fn(params, opt_state,
                                              _batch(pipe, cfg, dev))
            losses.append(float(loss))     # synchronizes the step
            step_s.append(time.perf_counter() - ts)
            if (step + 1) % log_every == 0:
                dt = (time.time() - t0) / log_every
                print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                      f"({dt * 1e3:.0f} ms/step)")
                t0 = time.time()
            if writer and (step + 1) % ckpt_every == 0:
                writer.save_async(step + 1,
                                  (params, opt_state, pipe.state_dict()))
    finally:
        if writer:
            writer.close()
    if stats_out is not None:
        stats_out.update(step_s=step_s, start=start)
    return losses, params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    losses, _ = train(args.arch, args.smoke, args.steps, args.batch,
                      args.seq, args.ckpt_dir, args.ckpt_every,
                      args.compress_grads, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    else:
        print("no step to run: the checkpoint is at or past --steps")


if __name__ == "__main__":
    main()
