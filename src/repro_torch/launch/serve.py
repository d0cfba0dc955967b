"""Serving: batched prefill + greedy decode with a KV cache, and
continuous batching over a paged KV pool (the reference's
``launch/serve.py``, dense attention family).

    python -m repro_torch.launch.serve --arch granite-3-2b --smoke \\
        --batch 4 --prompt-len 32 --gen 16
    python -m repro_torch.launch.serve --arch granite-3-2b --continuous \\
        --batch 8 --prompt-lens 64,960,300,512 --gen 64

``serve`` groups requests by prompt length; each group prefills its
whole prompt in one block call (``steps.make_cache_prefill_step``), then
``gen`` tokens decode greedily one step at a time.

``serve_continuous`` admits requests into and evicts them from a fixed
set of decode slots every step over one shared paged pool
(``models.paged``); decode runs as one joint ``paged_decode_step`` with
the fused CUDA kernel (``codegen_cuda.lower_paged_decode``, one launch
per layer), and the KV layout and page size come from the joint DSE
plan.  Before serving trusts the kernel it is certified against the
dense ``decode_step`` oracle under the resilience policy's deadline and
retry (``resilience.call_guarded``): a token the oracle does not score
within the model type's tolerance of its best raises (no quiet
fallback).  Prefill, decode steps, admissions and evictions are traced
as the reference's spans (``serve.prefill``, ``serve.decode_step``,
``serve.admit``, ``serve.evict``) with its ``serve.*_s`` histograms;
spans time the host and add no synchronization.  Runs on the card
unless ``device="cpu"``.

Not yet ported: the shape-bucket tuning layer (``bucketing=True`` raises,
ROADMAP §1 step 3) and the recurrent, MoE, audio and VLM families
(step 4).
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..core import resilience, telemetry
from ..core.options import refuse_bucketing
from ..device import resolve
from ..models import model
from ..models.transformer import check_dense
from . import steps as steps_mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prefill(prefill_fn, params, cache, prompt, ring: int,
             index0: int = 0):
    """Prefill ``prompt`` into ``cache`` starting at ``index0``,
    chunking at the KV ring boundary (a block write must not wrap)."""
    plen = prompt.shape[1]
    if plen == 0:
        raise ValueError("cannot prefill a zero-length prompt")
    i, nxt = 0, None
    while i < plen:
        chunk = min(plen - i, ring - ((index0 + i) % ring))
        nxt, cache = prefill_fn(params, cache, prompt[:, i:i + chunk],
                                index0 + i)
        i += chunk
    return nxt, cache


def _ring_len(cfg, max_len: int) -> int:
    """Slot count of the KV ring buffer (= the prompt-chunk bound)."""
    check_dense(cfg)
    return model.cache_specs(cfg, 1, max_len)["k"].shape[3]


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen: int,
          seed: int = 0, prompt_lens: Optional[Sequence[int]] = None,
          bucketing: bool = False, stats_out: Optional[Dict] = None,
          params=None, device=None) -> np.ndarray:
    """Serve ``batch`` requests; returns the (batch, gen) generated
    tokens (requests keep their input order even when mixed prompt
    lengths are re-grouped internally).  ``params`` defaults to
    ``model.init_params(cfg, seed)``; ``stats_out``, when given, is
    filled with prefill/decode wall times."""
    refuse_bucketing(bucketing)
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke)
    check_dense(cfg)
    if params is None:
        params = model.init_params(cfg, seed, dev)
    lens = list(prompt_lens) if prompt_lens else [prompt_len] * batch
    if len(lens) != batch:
        raise ValueError(f"--prompt-lens gave {len(lens)} lengths for "
                         f"--batch {batch}")
    if min(lens) <= 0:
        raise ValueError(f"prompt lengths must be positive: {lens}")
    prefill_fn = steps_mod.make_cache_prefill_step(cfg)
    step_fn = steps_mod.make_serve_step(cfg)

    rng = np.random.RandomState(seed)
    prompt_pool = rng.randint(0, cfg.vocab, (batch, max(lens)))

    # group requests by prompt length: each group prefills its whole
    # prompt in one call
    groups: Dict[int, List[int]] = {}
    for r, ln in enumerate(lens):
        groups.setdefault(ln, []).append(r)

    out = np.zeros((batch, gen), np.int64)
    prefill_s = decode_s = 0.0
    for ln, rows in sorted(groups.items()):
        gb = len(rows)
        prompt = torch.as_tensor(prompt_pool[rows][:, :ln],
                                 dtype=torch.int32, device=dev)
        cache = model.init_cache(cfg, gb, ln + gen, device=dev)
        ring = _ring_len(cfg, ln + gen)

        t0 = time.perf_counter()
        with telemetry.span("serve.prefill", prompt_len=ln, batch=gb):
            nxt, cache = _prefill(prefill_fn, params, cache, prompt, ring)
            _sync(dev)
        dt = time.perf_counter() - t0
        prefill_s += dt
        telemetry.observe("serve.prefill_s", dt)

        group_out = []
        t0 = time.perf_counter()
        for i in range(ln, ln + gen):
            ts = time.perf_counter()
            with telemetry.span("serve.decode_step", index=i, batch=gb):
                nxt, cache = step_fn(params, cache, nxt.reshape(gb, 1), i)
                group_out.append(nxt.cpu().numpy())
            telemetry.observe("serve.decode_token_s",
                              time.perf_counter() - ts)
        decode_s += time.perf_counter() - t0
        out[rows] = np.stack(group_out, axis=1)

    n_groups = len(groups)
    print(f"prefill {sorted(groups)} ({n_groups} group"
          f"{'s' if n_groups > 1 else ''}): {prefill_s:.2f}s; "
          f"decode {gen} tokens: {decode_s:.2f}s "
          f"({decode_s / max(gen, 1) * 1e3:.0f} ms/token)")
    if stats_out is not None:
        stats_out.update(prefill_s=prefill_s, decode_s=decode_s,
                         ms_per_token=decode_s / max(batch * gen, 1) * 1e3)
    return out


# the reference's certification tolerances (resilience.tolerances)
TOLERANCES = {"float32": (2e-3, 2e-3), "bfloat16": (2e-2, 2e-2),
              "float16": (2e-2, 2e-2)}


def near_best(logits: torch.Tensor, token: int, dtype: str) -> bool:
    """Whether ``token`` scores within the dtype's tolerance of the best
    logit of the row ``logits``: the greedy choice up to a tie that two
    float orders may break either way."""
    rtol, atol = TOLERANCES.get(dtype, (2e-3, 2e-3))
    best = float(logits.max())
    return float(logits[token]) >= best - (atol + rtol * abs(best))


def _certify_paged_decode(cfg, params, *, layout: str, page_size: int,
                          prompt_len: int = 5, gen: int = 4, seed: int = 0,
                          device=None, policy=None) -> str:
    """Certify the fused paged-decode kernel against the
    ``model.decode_step`` oracle: one short request is decoded greedily
    through both paths, both fed the oracle's tokens (the oracle's dense
    cache sized to the page-padded extent).  At every generated step the
    kernel's token must be the oracle's, or one the oracle scores within
    the model type's tolerance of its best (a tie the two summation
    orders break differently).  The probe runs under ``policy``'s
    deadline and transient retry (``resilience.call_guarded``); a sticky
    CUDA error propagates.  Returns what was compared; raises
    ``RuntimeError`` on a failed or unverifiable certification (the
    reference falls back to its reference path instead; the port does
    not hide the kernel)."""
    from ..models import paged

    dev = resolve(device)

    def probe() -> Tuple[bool, str]:
        ln = prompt_len
        cmax = -(-(ln + gen) // page_size) * page_size
        prompt = np.random.RandomState(seed).randint(0, cfg.vocab, (1, ln))
        oc = model.init_cache(cfg, 1, cmax, device=dev)
        pc = paged.PagedKVCache.init(cfg, 1, cmax, page_size=page_size,
                                     layout=layout, device=dev)
        tok, same = None, 0
        for i in range(ln + gen - 1):
            if i < ln:
                tok = torch.as_tensor(prompt[:, i:i + 1], dtype=torch.int32,
                                      device=dev)
            lo, oc = model.decode_step(params, cfg, oc, tok, i)
            lp, pc = paged.paged_decode_step(params, cfg, pc, tok,
                                             use_kernel=True)
            to, tp = steps_mod.greedy(lo, cfg), steps_mod.greedy(lp, cfg)
            if i >= ln - 1:
                row = model.mask_vocab_pad(lo, cfg)[0, -1].float()
                if not near_best(row, int(tp[0]), cfg.dtype):
                    return False, (
                        f"at step {i - ln + 1}: the kernel's token "
                        f"{int(tp[0])} scores {float(row[int(tp[0])]):.4g},"
                        f" the oracle's {int(to[0])} "
                        f"{float(row.max()):.4g}")
                same += int(to[0]) == int(tp[0])
            tok = to.reshape(1, 1)
        return True, (f"{same} of {gen} tokens identical, the rest within "
                      f"the {cfg.dtype} tolerance of the oracle's best")

    key = f"paged_decode/{layout}/p{page_size}"
    try:
        ok, why = resilience.call_guarded(probe, stage="certify", key=key,
                                          policy=policy)
    except resilience.CandidateFailure as exc:
        ok, why = False, f"{exc.kind}: {exc.detail}"
    if not ok:
        raise RuntimeError(f"{key} failed certification {why}")
    return why


def serve_continuous(arch: str, smoke: bool, slots: int, gen: int,
                     seed: int = 0,
                     prompt_lens: Optional[Sequence[int]] = None,
                     prompt_len: int = 32,
                     page_size: Optional[int] = None,
                     layout: Optional[str] = None,
                     use_kernel: bool = True, certify: bool = True,
                     bucketing: bool = False, params=None,
                     device=None, dtype: Optional[str] = None,
                     policy=None) -> Tuple[np.ndarray, Dict]:
    """Continuous-batching serve over one shared paged KV pool.

    ``slots`` concurrent decode lanes share a page pool; each decode
    step first *admits* waiting requests into free slots (batch-1 dense
    prefill, then the prefilled K/V scattered into freshly allocated
    pages) and *evicts* finished ones (pages back to the free list),
    then runs ONE joint ``paged_decode_step`` over all slots.  The KV
    layout and page size come from the joint DSE plan
    (``ops.resolve_plan("paged_decode", ...)``, for the device's tier)
    unless given; it raises where the DSE finds no plan.  With
    ``use_kernel`` and ``certify`` the fused kernel is certified against
    the ``decode_step`` oracle first, under ``policy`` (a
    ``resilience.Policy``; its deadline and retry), and a mismatch
    raises.  ``params``
    defaults to ``model.init_params(cfg, seed)``; ``dtype`` (say
    "float32") replaces the config's type.

    Returns ``(tokens, stats)``: the (n_requests, gen) generated tokens
    in request order, and occupancy, latency and plan stats under the
    reference's keys (``use_pallas`` says whether the fused kernel
    served).
    """
    from ..core import cost as cost_mod
    from ..kernels import ops
    from ..models import paged

    refuse_bucketing(bucketing)
    dev = resolve(device)
    cfg = get_config(arch, smoke=smoke)
    if dtype is not None:
        cfg = cfg.with_(dtype=dtype)
    check_dense(cfg)
    if params is None:
        params = model.init_params(cfg, seed, dev)
    lens = list(prompt_lens) if prompt_lens else [prompt_len] * slots
    if min(lens) <= 0:
        raise ValueError(f"prompt lengths must be positive: {lens}")
    n_req = len(lens)
    head_dim = cfg.head_dim or (cfg.d_model // max(cfg.n_heads, 1))
    max_ctx = max(lens) + gen

    (sel_layout, sel_ps, blk, depth), plan = ops.resolve_plan(
        "paged_decode", int(max_ctx), int(head_dim), device=dev)
    layout = layout or sel_layout
    page_size = int(page_size or sel_ps)

    certified = None
    if use_kernel and certify:
        print("certified paged_decode:", _certify_paged_decode(
            cfg, params, layout=layout, page_size=page_size, device=dev,
            policy=policy))
        certified = True

    npm = -(-max_ctx // page_size)
    cache = paged.PagedKVCache.init(cfg, slots, npm * page_size,
                                    page_size=page_size, layout=layout,
                                    device=dev)
    free_pages = list(range(cache.n_pages - 1, 0, -1))  # page 0 reserved
    for s in range(slots):                              # park every slot
        cache = cache.assign_pages(s, [0] * npm, 0)

    prefill_fn = steps_mod.make_cache_prefill_step(cfg)
    prompt_pool = np.random.RandomState(seed).randint(
        0, cfg.vocab, (n_req, max(lens)))

    queue = deque(range(n_req))
    slot_req: List[Optional[int]] = [None] * slots
    slot_pages: List[List[int]] = [[] for _ in range(slots)]
    slot_done = [0] * slots
    next_tok = np.zeros(slots, np.int32)
    out = np.zeros((n_req, gen), np.int64)
    steps = active_steps = admitted = evicted = 0
    prefill_s = decode_s = 0.0
    dense_words = paged_words = 0   # modeled KV traffic over the trace
    hkv = cfg.n_kv_heads

    while queue or any(r is not None for r in slot_req):
        for s in range(slots):                               # admit
            if slot_req[s] is not None or not queue:
                continue
            r = queue[0]
            ln = lens[r]
            need = -(-(ln + gen) // page_size)
            if len(free_pages) < need:
                break
            queue.popleft()
            pages = [free_pages.pop() for _ in range(need)]
            t0 = time.perf_counter()
            with telemetry.span("serve.admit", request=r, slot=s,
                                prompt_len=ln, pages=need):
                dcache = model.init_cache(cfg, 1, ln, device=dev)
                prompt = torch.as_tensor(prompt_pool[r:r + 1, :ln],
                                         dtype=torch.int32, device=dev)
                first, dcache = _prefill(prefill_fn, params, dcache,
                                         prompt, _ring_len(cfg, ln))
                cache = cache.assign_pages(s, pages, ln)
                cache = cache.write_tokens(s, dcache["k"][:, 0, :, :ln],
                                           dcache["v"][:, 0, :, :ln], 0)
                next_tok[s] = int(first[0])
            dt = time.perf_counter() - t0
            prefill_s += dt
            telemetry.observe("serve.admit_s", dt)
            telemetry.observe("serve.prefill_s", dt)
            slot_req[s], slot_pages[s], slot_done[s] = r, pages, 0
            admitted += 1

        active = [s for s in range(slots) if slot_req[s] is not None]
        # modeled decode traffic of THIS step: a dense continuous server
        # sizes every lane's cache to the longest possible context, the
        # paged pool streams only live pages
        live = [lens[slot_req[s]] + slot_done[s] for s in active]
        dense_words += cfg.n_layers * cost_mod.dense_decode_traffic_words(
            len(active), max_ctx, hkv, head_dim)
        paged_words += cfg.n_layers * cost_mod.paged_decode_traffic_words(
            live, page_size, hkv, head_dim)
        t0 = time.perf_counter()
        with telemetry.span("serve.decode_step", step=steps,
                            active=len(active)):
            tok = torch.as_tensor(next_tok.reshape(slots, 1), device=dev)
            logits, cache = paged.paged_decode_step(params, cfg, cache, tok,
                                                    use_kernel=use_kernel)
            nxt = steps_mod.greedy(logits, cfg).cpu().numpy()
        dt = time.perf_counter() - t0
        decode_s += dt
        telemetry.observe("serve.decode_token_s", dt / max(len(active), 1))
        steps += 1
        active_steps += len(active)

        # parked slots wrote their garbage token to reserved page 0; pin
        # their lengths back to zero so they never walk off the table
        mask = np.zeros(slots, np.int32)
        mask[active] = 1
        cache = cache.replace(seq_lens=cache.seq_lens
                              * torch.as_tensor(mask, device=dev))

        for s in active:
            r = slot_req[s]
            out[r, slot_done[s]] = int(nxt[s])
            next_tok[s] = nxt[s]
            slot_done[s] += 1
            if slot_done[s] == gen:                          # evict
                te = time.perf_counter()
                with telemetry.span("serve.evict", request=r, slot=s):
                    free_pages.extend(slot_pages[s])
                    cache = cache.assign_pages(s, [0] * npm, 0)
                    slot_req[s], slot_pages[s] = None, []
                telemetry.observe("serve.evict_s", time.perf_counter() - te)
                evicted += 1

    occupancy = active_steps / max(steps * slots, 1)
    tokens_out = n_req * gen
    stats = {
        "layout": layout, "page_size": page_size, "block": int(blk),
        "depth": int(depth), "plan_sizes": dict(plan.sizes),
        "use_pallas": bool(use_kernel), "certified": certified,
        "slots": slots, "requests": n_req, "steps": steps,
        "occupancy": occupancy, "admitted": admitted,
        "evicted": evicted, "prefill_s": prefill_s,
        "decode_s": decode_s,
        "ms_per_token": decode_s / max(tokens_out, 1) * 1e3,
        "modeled_dense_traffic_words": int(dense_words),
        "modeled_paged_traffic_words": int(paged_words),
    }
    print(f"continuous serve: {n_req} requests over {slots} slots, "
          f"{steps} steps, occupancy {occupancy:.2f}; "
          f"layout={layout} page_size={page_size} "
          f"kernel={use_kernel} certified={certified}; "
          f"decode {decode_s:.2f}s "
          f"({stats['ms_per_token']:.1f} ms/token)")
    return out, stats


def _parse_lens(text: Optional[str]) -> Optional[Tuple[int, ...]]:
    if not text:
        return None
    return tuple(int(x) for x in text.split(",") if x.strip())


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-lens", type=str, default=None,
                    help="comma-separated per-request prompt lengths "
                         "(mixed batch; overrides --prompt-len)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--bucketing", action="store_true",
                    help="shape-bucket warm starts (not yet ported: "
                         "raises)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a paged KV pool: "
                         "--batch is the slot count, --prompt-lens the "
                         "request trace (admit/evict per decode step)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="override the DSE-selected KV page size "
                         "(--continuous only)")
    ap.add_argument("--layout", choices=("split", "fused"), default=None,
                    help="override the DSE-selected KV layout "
                         "(--continuous only)")
    ap.add_argument("--no-pallas", "--no-kernel", dest="no_kernel",
                    action="store_true",
                    help="use the reference paged attention instead of "
                         "the fused kernel (--continuous only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.continuous:
        toks, _ = serve_continuous(
            args.arch, args.smoke, args.batch, args.gen,
            prompt_lens=_parse_lens(args.prompt_lens),
            prompt_len=args.prompt_len, page_size=args.page_size,
            layout=args.layout, use_kernel=not args.no_kernel,
            bucketing=args.bucketing, device=args.device)
    else:
        toks = serve(args.arch, args.smoke, args.batch, args.prompt_len,
                     args.gen, prompt_lens=_parse_lens(args.prompt_lens),
                     bucketing=args.bucketing, device=args.device)
    print("generated token block:", toks.shape)


if __name__ == "__main__":
    main()
