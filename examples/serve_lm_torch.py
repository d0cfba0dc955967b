"""Serving example on the PyTorch/CUDA port: batched KV-cache decode on
three architecture families (dense GQA, Mamba-2 SSD state, Zamba-2
hybrid).

    PYTHONPATH=src python examples/serve_lm_torch.py               # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
from typing import Dict, Optional, Sequence

from repro_torch.launch.serve import serve

ARCHS = ("granite-3-2b", "mamba2-370m", "zamba2-2.7b")


def main(argv: Optional[Sequence[str]] = None,
         stats_out: Optional[Dict] = None) -> str:
    """Serve each architecture's reduced config; returns the lines it
    printed itself (``serve``'s timing line goes to stdout only).
    ``stats_out``, when given, gets per architecture the generated
    tokens (``"tokens"``, (batch, gen)) and ``serve``'s own stats."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    lines = []
    for arch in ARCHS:
        lines.append(f"== {arch} (reduced config) ==")
        print(lines[-1])
        stats = {}
        toks = serve(arch, smoke=True, batch=2, prompt_len=16, gen=8,
                     device=args.device, stats_out=stats)
        lines.append("   sample token ids: "
                     f"{toks[0, :8].reshape(-1)[:8].tolist()}")
        print(lines[-1])
        if stats_out is not None:
            stats_out[arch] = dict(stats, tokens=toks)
    return "\n".join(lines)


if __name__ == "__main__":
    main()
