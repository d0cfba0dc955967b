"""Fault-tolerance drill on the PyTorch/CUDA port: train, checkpoint,
'lose' a node, plan a rescale, and restart from the checkpoint, training
on with identical data.

    PYTHONPATH=src python examples/elastic_restart_torch.py               # the card
    PYTHONPATH=src python examples/elastic_restart_torch.py --device cpu
"""
import argparse
import tempfile
from typing import Dict, Optional, Sequence

from repro_torch.launch.train import train
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 StragglerPolicy, plan_rescale)


def main(argv: Optional[Sequence[str]] = None,
         stats_out: Optional[Dict] = None) -> str:
    """Run the five phases; returns the lines it printed itself
    (``train``'s step log goes to stdout only).  ``stats_out``, when
    given, gets phase 1's and phase 5's losses (``"losses_1"``,
    ``"losses_5"``) and the step phase 5 resumed at (``"start_5"``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    lines = []

    def say(text=""):
        print(text)
        lines.append(str(text))

    with tempfile.TemporaryDirectory() as d:
        say("== phase 1: train 10 steps, checkpoint every 5 ==")
        losses_1, _ = train("granite-3-2b", smoke=True, n_steps=10, batch=2,
                            seq=32, ckpt_dir=d, ckpt_every=5,
                            device=args.device)

        say("\n== phase 2: heartbeat monitor declares a node dead ==")
        mon = HeartbeatMonitor([f"node{i}" for i in range(16)], timeout_s=30)
        for n in list(mon.nodes)[:-1]:
            mon.heartbeat(n, now=1000.0)
        mon.nodes["node15"].last_heartbeat = 900.0
        dead = mon.sweep(now=1000.0)
        say(f"dead: {dead} | survivors: {len(mon.alive())}")

        say("\n== phase 3: rescale plan from survivors ==")
        plan = plan_rescale(15 * 16, model_parallel=16)
        say(f"new mesh: data={plan.data} x model={plan.model} "
            f"(dropped {plan.dropped})")

        say("\n== phase 4: straggler policy ==")
        pol = StragglerPolicy()
        for _ in range(4):
            d_ = {f"r{i}": 1.0 for i in range(8)}
            d_["r5"] = 2.5
            evict = pol.record_step(d_)
        say(f"evict: {evict}")

        say("\n== phase 5: restart resumes from checkpoint ==")
        stats = {}
        losses, _ = train("granite-3-2b", smoke=True, n_steps=14, batch=2,
                          seq=32, ckpt_dir=d, ckpt_every=5,
                          device=args.device, stats_out=stats)
        say(f"resumed and ran {len(losses)} more steps; final loss "
            f"{losses[-1]:.3f}")
    say("OK")
    if stats_out is not None:
        stats_out.update(losses_1=losses_1, losses_5=losses,
                         start_5=stats["start"])
    return "\n".join(lines)


if __name__ == "__main__":
    main()
