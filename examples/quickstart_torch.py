"""Quickstart: the paper's pipeline end to end on matrix multiply, on
the PyTorch/CUDA port.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. write GEMM as nested parallel patterns (Map of MultiFold);
2. tile it (strip-mine -> stage lifting -> interchange -> tile copies);
3. inspect the cost model (Fig. 5c-style traffic table), the
   metapipeline schedule (Fig. 6-style stages) and the shared-memory
   plan for the card's tier;
4. execute the eager PyTorch oracle AND the generated CUDA kernel (the
   tiled-GEMM template, ``csrc/tiled_gemm.cuh``); compare both with the
   numpy reference.  On the CPU the template's plain version runs.
"""
import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.codegen_cuda import lower
from repro_torch.core.codegen_torch import execute
from repro_torch.core.cost import device_tier, traffic
from repro_torch.core.ir import describe
from repro_torch.core.memory import plan_memory
from repro_torch.core.scheduling import build_schedule
from repro_torch.core.strip_mine import tile
from repro_torch.device import resolve
from repro_torch.kernels.autotile import select_gemm_tiles
from repro_torch.patterns.analytics import gemm


def main(argv: Optional[Sequence[str]] = None,
         stats_out: Optional[Dict] = None) -> str:
    """Run the quickstart; returns what it printed.  ``stats_out``, when
    given, gets the numpy reference and both outputs (``"reference"``,
    ``"eager"``, ``"kernel"``, on the host)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    tier = device_tier(dev)
    lines = []

    def say(text=""):
        print(text)
        lines.append(str(text))

    pattern, sizes, make_inputs, reference = gemm(m=128, n=128, k=128,
                                                  bm=64, bn=64, bk=64)
    say("== original PPL program ==")
    say(describe(pattern))

    tiled = tile(pattern, sizes)
    say("\n== tiled (strip-mined + interchanged + tile copies) ==")
    say(describe(tiled))

    say("\n== main-memory traffic (words) ==")
    base_t, tiled_t = traffic(pattern), traffic(tiled)
    for name in base_t.reads:
        say(f"  {name}: base={base_t.reads[name]} "
            f"tiled={tiled_t.reads[name]} "
            f"({base_t.reads[name] / tiled_t.reads[name]:.1f}x fewer)")

    say("\n== metapipeline schedule ==")
    say(build_schedule(tiled).describe())

    say(f"\n== memory plan (shared memory, {tier.name}) ==")
    say(plan_memory(tiled, vmem_budget_bytes=tier.onchip_bytes).describe())

    say("\n== automated tile-size selection (the paper's future work) ==")
    choice = select_gemm_tiles(512, 512, 512, tier=tier)
    say(f"  DSE picks bm={choice.block_m} bn={choice.block_n} "
        f"bk={choice.block_k} (traffic {choice.traffic_words} words, "
        f"shared memory {choice.vmem_bytes} B)")

    inputs = make_inputs()
    ref = reference(inputs)
    out_eager = execute(tiled, inputs, device=dev).cpu().numpy()
    out_kernel = lower(tiled, device=dev)(**inputs).cpu().numpy()
    say(f"\neager lowering max err: {np.abs(out_eager - ref).max()}")
    say(f"{'cuda kernel' if dev.type == 'cuda' else 'plain version'} "
        f"max err:  {np.abs(out_kernel - ref).max()}")
    say("OK")
    if stats_out is not None:
        stats_out.update(reference=ref, eager=out_eager, kernel=out_kernel)
    return "\n".join(lines)


if __name__ == "__main__":
    main()
