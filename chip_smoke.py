#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the path from ``src/repro_torch/kernels/csrc``
(one nvcc per translation unit, all at once) and counts HGMMA (wgmma),
HMMA (mma.sync), UTMALDG (TMA), LDGSTS (cp.async) and FFMA in the SASS
of each variant of ``matmul``, ``flash_attention``, ``paged_decode``,
``ssd_scan``, the tiled GEMM, the fused-DAG template, the keyed
hand kernels ``fused_kmeans`` and ``groupby_fold`` (one library per
shape, plan and form: ``keyed_libraries``) and the one-launch kernels
(the ``filter_fold`` library and the tiled FlatMap of ``lower_auto``'s
filter) (``cuobjdump -sass``; it fails without cuobjdump, when a
tensor-core variant has no HGMMA, the GEMM no LDGSTS or FFMA or any
HGMMA, the paged attend kernel no LDGSTS, an ``ssd_scan`` pass any HMMA
or HGMMA, or, where it stages B, C or x, no LDGSTS or FFMA, a fused-DAG,
``fused_kmeans``, filter-fold or FlatMap kernel no LDGSTS, or a fused-DAG,
keyed, filter-fold or FlatMap library any ATOMS, ATOMG, ATOM or RED;
ptxas must report no stack frame for any of those), then:

  * runs ``lower_pipeline(pipe)`` -- the port's own DSE on the card's
    budget, then the fused-DAG CUDA megakernel -- for each of the five
    analytics pipelines at full size: tpchq6 at 6,000,000 rows (TPC-H
    SF1 lineitem, 6,001,215 rows, cut to a multiple of 128), the others
    at 4,194,304 rows with the pipelines' own widths.  Each fused-DAG
    phase (and ``lower_auto``'s gda below) prints its CAM terminals'
    forms (every one must take the register form) and the CAM staging
    beside the plan's charge, calls the kernel twice (bitwise equal) and
    shows the device time of ``fused_dag_kernel`` and
    ``combine_partials``;
  * runs ``lower(tile(gemm), depth=d)`` at m = n = k = 4096 in float32
    at the analytics tile 64x64x64, depth 2, and at 128x128x32, depth 3
    (the template at the plan's tile, a ``d``-slot ``cp.async`` ring),
    held at RTOL/ATOL after proving that limit catches a dropped K slab
    and a stale ring slot; then ``lower_auto`` of SUITE's GEMM at 4096^3
    (``lower_auto[gemm]``): the DSE explores the template's own space
    (``dse.template_kernel``), the plan's charge must equal the bytes the
    template allocates at that tile, one launch a call, held and timed
    as the fixed tiles are;
  * runs ``lower_auto(p)`` -- the port's single-pattern DSE on the
    card's budget, then the template it picks -- for three programs:
    the outer product at m = n = 16,384 (the tiled-Map kernel, a 1 GiB
    output), gda as one keyed fold at 4,194,304 rows (the CAM), and the
    paper's Table 2 filter ``x.flatMap{e => if (e > 0) [e] else []}``
    at 6,000,000 rows (the tiled-FlatMap kernel: one pass, one launch a
    call by the trace, calls A, B, A on two inputs each bitwise as the
    plain version);
  * runs the hand-written kernels of ``repro_torch.kernels`` through
    their entry points, each at the DSE's plan for the card unless said
    otherwise: ``matmul`` at 4096^3 in float32 at its default blocks and
    through ``autotile.tuned_matmul`` (the FFMA kernel), and in bfloat16
    (the wgmma kernel; the per-variant counts show which ran); ``filter_reduce``
    and ``fused_filter_fold`` on TPC-H Q6 (6,000,000 rows of discount and
    extended price, ``0.05 <= discount < 0.075``; the ring at the plan's
    block and depth, one launch a call by the trace, calls A, B, A on two
    inputs each as the plain version); ``ops.groupby`` on
    4,194,304 rows into 64 keys of 8 values (about 1% of the keys
    outside the table; the shared form) and as MoE's ``router_counts``
    (8 experts, values one; the register form); ``fused_kmeans_step`` on
    the kmeans pipeline's inputs at the rule's CAM form, then at the
    other form (timed beside it), and beside the compiler's fused-DAG
    kernel for the same step (counts equal).  These phases print their
    form and shared bytes, call the kernel twice (bitwise equal) and
    show the device time of the kernel and of ``combine_partials``;
  * ``[nearest[kmeans.lloyd]]`` (alone with ``--kmeans``): the benchmark
    cell ``kmeans.lloyd``'s program (``bench/programs/kmeans_lloyd.py``)
    through ``lower_pipeline`` at its shape, 8,099,840 MNIST-like points
    of 784 dimensions (25.4 GB, ``bench/data/mnist_like.py``) and 256
    centroids: the nearest-row DAG's ``nearest_assign_kernel`` and
    ``nearest_fold_kernel`` and their two ``combine_partials``.  Two
    Lloyd steps, each called twice (bitwise equal), the kernel's and the
    plain path's answers held to the float64 reference's admissible
    intervals (counts exactly, sums within the cell's limit), their
    counts apart by at most the ambiguous points, and a dropped last
    centroid tile caught; launch counts from the program's counters and
    a device trace; the step's ms, the plain path's, and each kernel's
    device ms against the bound of its least work (``kernel_work``);
  * runs the LM kernels at the widths of ``repro_torch.configs``:
    ``flash_attention`` at granite-3-2b's (causal prefill of 2 x 4096
    tokens in float32 and bfloat16, decode of 32 rows over 32,768 keys)
    and mixtral-8x22b's (window 4096 over 8,192 tokens), ``ssd_scan`` at
    mamba2-370m's (4 x 4096 steps, float32 and bfloat16; its four passes
    each counted and timed on the device; in bfloat16 also held within
    1 bf16 ulp of the float32 kernel on the widened inputs).  Each output
    is held against the plain version and a float64 oracle at rtol
    ``tol`` and an atol of ``tol`` times the oracle's root mean square:
    per output row for attention (rows that average thousands of keys
    are small), over the whole output for the SSD.  ``tol`` is 2e-3 for
    float32 attention, SSD_F32_TOL for the float32 SSD, 2e-2 for
    bfloat16.  Each limit is first proved to catch planted faults: a
    dropped kv block in the first and in the last query tile, the SSD's
    state carry zeroed at a chunk boundary, one chunk's state dropped
    from its carry and one batch row scored with another's C Bᵀ over a
    chunk, for float32 the oracle's
    output rounded to bfloat16, and, where the keys are split (decode),
    one split's partial dropped from the combine.  Every bfloat16
    attention phase must run the wgmma kernel, by the per-variant counts;
  * runs ``lower_paged_decode`` (the paged KV append and attention) at
    granite-3-2b's widths: 32 requests of seeded lengths up to 8,191
    tokens (page-boundary lengths among them) over bf16 pools with
    shuffled, disjoint page tables, page sizes 8 and 64, split and fused
    layouts.  The pools are held bitwise against the plain version, the
    float32 output against it and a float64 gather-and-softmax oracle
    at rtol SSD_F32_TOL and a per-row atol of SSD_F32_TOL x the oracle
    row's root mean square, after proving that limit catches the longest
    request's last live page dropped, the append skipped, p rounded to
    bfloat16 before PV, the output rounded to bfloat16 and one split's
    partial dropped in the combine (the kernel splits each request's
    context across blocks: the splits and blocks are printed);
  * serves granite-3-2b at full width through ``serve_continuous`` (40
    layers, 16 requests of seeded prompts up to 960 tokens over 8 slots,
    64 tokens each, the DSE's paged plan, the kernel certified first),
    in bfloat16 and in float32.  It counts one kernel launch per layer
    and decode step, every request admitted and evicted, fewer modeled
    words than a dense cache, and holds the tokens against the dense
    ``decode_step`` oracle, teacher-forced: in float32 every token is
    the oracle's greedy token; in bfloat16, whose logits tie at the top
    in some steps, every token is one the oracle scores within the bf16
    tolerance of its best, a limit first proved to reject another
    request's tokens and a served run with the kernel's append skipped
    (which certification must also refuse).  One decode step is profiled
    (host clock, device busy time, the paged kernels' share), and the
    kernel is timed at the serving shapes;
  * ``[moe]``: serves llama4-maverick-400b-a17b at its published widths
    (d_model 5120, 40/8 heads of 128, 128 experts top-1 and a shared
    expert, vocab 202,048, bf16) cut to 2 layers, one dense and one MoE
    (18.55e9 random parameters, 37.1 GB, made on the card), through
    ``launch.serve._serve_continuous`` with the same trace as granite's:
    the planted skipped append first (certification must raise, its
    tokens fail the bf16 rule), then the served run held against the
    teacher-forced dense oracle (the served tokens in blocks of a
    step's routing group) by the bf16 rule, one step profiled beside its
    byte floor (every weight but the embedding table, all 128 experts
    included, and the live K/V); the router's ``groupby_fold`` over 128
    experts (the shared form) on a prefill's hidden states, exactly the
    plain version's after proving a dropped row is caught;
    ``lower_paged_decode`` at Llama-4's attention widths (group 5, head
    dim 128) over 32 requests up to 8,191 tokens, both layouts, planted
    faults first; and one mixtral-8x22b MoE layer at full width on
    2 x 4096 tokens in bf16, held against float64 on its own routing
    (the margins of the k-th logit printed; a routing that differs from
    a float32 run's must be a tie);
  * the LM kernels at the card's own plans (``auto_tile=True``):
    ``flash_attention`` at qwen2-72b's widths (64 / 8 heads of 128:
    prefill 2 x 4096, decode 32 x 32,768 keys) and ``ssd_scan`` at
    mamba2-370m's state 128, each plan's charged bytes printed beside
    the bytes the kernel's library reports (they must be equal), held
    and timed as the fixed-block rows are;
  * ``[buckets]``: ``serve(bucketing=True)`` of qwen2-72b at published
    widths cut to 2 layers on prompts 100, 100, 110, 110: one miss, one
    warm start with no build in the foreground, its background re-tune
    certified on the card and promoted, then (memo cleared) a second
    serve of exact hits only, with the same tokens;
  * ``[ssm]`` and ``[hybrid]``: mamba2-370m and zamba2-2.7b at their
    published widths (random weights), bf16 and f32, serving 16
    requests in prompt groups of 32, 96 and 160 tokens, 32 tokens each
    (a token scan prefills each group), held to a teacher-forced oracle
    (``model.forward`` with the chunked SSD through ``ssd_scan_plain``):
    f32 tokens identical, bf16 tokens within the larger of the bf16
    tolerance and the oracle's own bf16 error, a rule first shown to
    reject a run whose conv state is not carried; one decode step
    profiled (host ms, device busy, idle share, launches) beside its
    byte floor;
  * ``[audio]`` and ``[vlm]``: musicgen-medium (4 codebooks: embeddings
    summed, one head each) and internvl2-1b at their published widths
    and depths, bf16 and f32, served on the dense cache (``serve``) for
    the same 16 requests: tokens on every codebook held to a
    teacher-forced ``model.forward`` oracle by the rule above, a rule
    first shown in float32 to reject every request of a run with a
    planted fault (MusicGen's last codebook left out of the embedding
    sum; InternVL's last layer writing its K/V into a copy, not the
    cache); one decode step profiled;
  * ``[train]``: granite-3-2b at its published widths and 40 layers,
    bf16, remat on, through ``launch.train.train`` for TRAIN_STEPS steps
    of TRAIN_BATCH x TRAIN_SEQ tokens (losses finite, the first within
    2e-2 of a float32 forward of the same weights; ms a step, tokens a
    second, peak memory, one step profiled); one float32 train step of
    granite-3-2b, musicgen-medium and internvl2-1b (256 zero prefix rows)
    cut to 2 layers held to the same step in float64 run by the port's
    code (loss 2e-3 relative, every gradient rtol 2e-3 / atol 2e-3 x its
    RMS, the AdamW update 1e-5 relative), after proving those limits
    catch unshifted labels, the VLM prefix left in the loss, a block's
    output detached and the bias correction dropped; and a restart at
    the 2-layer cut: 4 steps uninterrupted against 2 steps, a checkpoint
    restored into fresh tensors (bitwise what was saved) and 2 more
    (batches bitwise, losses within 1e-5);
  * ``[examples]`` (after ``[dist]``; alone with ``--examples``): the
    port's four examples, ``examples/*_torch.py``, each through its
    ``main``.  quickstart on the CPU, then on the card: exactly one
    ``tiled_gemm`` launch (128^3, tiles 64^3, depth 2), its output at
    EXAMPLE_TOL against the template's plain version and numpy after
    proving that limit catches a dropped K slab, its IR, traffic and
    schedule text equal to the CPU run's, timed (a ``kernels`` row).
    serve_lm in float32 and in bfloat16, on the CPU and on the card from
    the same weights drawn on the host: float32 tokens identical,
    bfloat16 tokens ones a teacher-forced CPU oracle scores within the
    bf16 tolerance of its best; each rule first shown to reject a card
    run with the last layer's K/V write skipped and the conv state
    dropped.  train_lm at LM_130M (full width and depth), 200 steps of
    8 x 256: losses finite, the last below the first by more than the
    bf16 tolerance (a limit the first weights' loss on the last batch,
    a run without updates, must fail), the first three within the bf16
    tolerance of the same three steps on the CPU from the same weights
    (a forward with every norm's scaling dropped must fail it); ms a
    step, tokens a second, peak memory, each checkpoint write's
    seconds.  elastic_restart: phase 5 resumes at step 10, its losses
    within EXAMPLE_TOL of an uninterrupted 14-step run on the card
    (bitwise equality printed), a limit first shown to reject a resume
    from step 5's checkpoint relabelled as step 10.

Each run resets the kernel's launch count just before, reads it just
after, and fails if the kernel did not run.  Each result is held
against the kernel's plain PyTorch version on the card and against the
numpy reference: Map outputs and the GEMM at float32 rtol/atol
2e-3/2e-3; the outer product and the filter bitwise (the filter's
count exactly, the buffer's tail zero); fold and CAM sums within
SUM_RTOL of their largest magnitude, a limit the script first proves
tighter than what three planted faults would shift them by (a row per
tile, a block's partial, a warp's accumulators of a block); counts
exactly; the hand-written ``matmul`` at float32 rtol/atol 2e-3 against
its plain version, ``torch.matmul`` and a float64 product of 64 rows
(bfloat16 at 2e-2).  Times are medians of
CUDA-event timings with warm-up excluded.  The last lines are the
``kernels`` JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.  Needs
one card; exits non-zero without one, or outside a checkout of the
repository.
"""
from __future__ import annotations

import contextlib
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

RTOL = ATOL = 2e-3           # float32 tolerance of the reference's tests
# fold / CAM sums: |kernel - float64 reference| <= SUM_RTOL * max|reference|
SUM_RTOL = 1e-5
EXACT = {"km_counts", "router"}  # integer counts below 2**24: exact in f32
BF16_TOL = 2e-2              # bfloat16 tolerance of the reference's tests
# the float32 SSD: rtol, and atol as a share of the output's root mean square;
# the kernel's error is about 1e-5 of its largest output, and an output
# rounded to bfloat16 (up to 2**-8 of each value) must fail it
SSD_F32_TOL = 1e-4
TPCH_ROWS = 6_000_000        # TPC-H SF1 lineitem (6,001,215) cut to 128s
ROWS = 4_194_304             # 2**22
GEMM_N = 4096
OUTER_N = 16_384             # outer product: a 1 GiB float32 output
CHECK_ROWS = 256             # outer-product rows held against numpy
WARMUP, REPS, BATCH = 3, 10, 10
TRACES = 6                   # profiler sessions of one trace (``trace``)
REPLACES = "src/repro/core/codegen_pallas.py"
HAND = "src/repro/kernels"   # the TPU kernels written by hand
CSRC = "src/repro_torch/kernels/csrc"
BF16_PEAK = 989.4e12         # H100 SXM dense bf16 tensor-core FLOP/s
Q6_LO, Q6_HI = 0.05, 0.075   # Q6: discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def median_ms(fn, torch, reps: int = REPS, batch: int = BATCH) -> float:
    """Median over ``reps`` of the per-call time of ``batch`` back-to-back
    calls between two CUDA events (so the card, not the host's enqueue,
    sets the time), after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / batch)
    times.sort()
    return times[len(times) // 2]


def host_ms(fn, torch, calls: int = 100) -> float:
    """The host's time to issue one call of ``fn`` (the wrapper's Python
    and its launch), on the host clock over ``calls`` calls that are not
    waited for, after WARMUP calls; a call is host-bound when this
    exceeds its device time."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def _as_double(t, torch):
    return torch.as_tensor(t).detach().double().cpu()


def max_err(got, want, torch, what: str, tol: float = RTOL) -> float:
    """Max abs error of ``got`` against ``want``; fails outside rtol =
    atol = ``tol``."""
    g, w = _as_double(got, torch), _as_double(want, torch)
    if tuple(g.shape) != tuple(w.shape):
        fail(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not bool(torch.isfinite(g).all()):
        fail(f"{what}: non-finite values")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        bad = float(((g - w).abs() / (tol + tol * w.abs())).max())
        fail(f"{what}: max abs err {err:.3e} exceeds rtol/atol "
             f"{tol}/{tol} (worst err/tol {bad:.3f})")
    return err


def as_outputs(value, names) -> dict:
    return value if isinstance(value, dict) else {names[0]: value}


def fault_shifts(reference_at, host, n: int, block: int, grid: int,
                 ctas: int, names, lane_rows: int = 1, piece: int = 0
                 ) -> dict:
    """What three planted faults would shift each fold / CAM output by:
    dropping the first row of every grid step, dropping the partial of
    the last persistent block (the one with the fewest steps: steps
    ctas - 1, 2 ctas - 1, ...), and dropping the accumulators of that
    block's first warp.  A thread takes ``lane_rows`` consecutive rows
    at a time, 256 threads a round over each ``piece`` of a step (the
    whole step by default): in the fused DAG's CAM, ``groupby_fold`` and
    ``fused_kmeans`` one row, so warp 0 owns rows r % 256 < 32 of every
    step (per-warp tables added in warp order make this fault possible);
    in the filter-folds a float4, so warp 0 owns offsets o % 1024 < 128
    of every ring piece.  Each output is a sum over rows, so a shift is
    the float64 reference (``reference_at(rows)`` builds it) on just the
    dropped rows.  Returns fault -> output -> max abs shift."""
    from repro_torch.core.codegen_cuda import DAG_WARPS

    last = np.arange(ctas - 1, grid, ctas)
    lanes = np.arange(block)
    offset = lanes % piece if piece else lanes
    warp0 = lanes[(offset // lane_rows) % (32 * DAG_WARPS) < 32]
    dropped = {"row per tile": np.arange(grid) * block,
               "block partial": (last[:, None] * block + lanes).ravel(),
               "warp of a block": (last[:, None] * block + warp0).ravel()}
    out = {}
    for what, rows in dropped.items():
        sub = {k: v[rows] if v.shape[:1] == (n,) else v
               for k, v in host.items()}
        ref = as_outputs(reference_at(rows.size)(sub), names)
        out[what] = {k: float(np.abs(np.asarray(v, np.float64)).max())
                     for k, v in ref.items()}
    return out


def check_sum(key, got, plain, ref, shifts, torch, what: str):
    """Hold a fold / CAM output against the plain version and the float64
    reference within its limit, after proving the limit tighter than
    every planted fault's shift.  Returns (err vs plain, err vs
    reference, limit)."""
    g, p, r = (_as_double(t, torch) for t in (got, plain, ref))
    for name, t in (("kernel", g), ("plain", p)):
        if tuple(t.shape) != tuple(r.shape) or not bool(
                torch.isfinite(t).all()):
            fail(f"{what}: {name} output not finite of shape "
                 f"{tuple(r.shape)}")
    limit = 0.0 if key in EXACT else SUM_RTOL * float(r.abs().max())
    for fault, by_key in shifts.items():
        if not limit < by_key[key]:
            fail(f"{what}: limit {limit:.4g} would not catch a dropped "
                 f"{fault} (shift {by_key[key]:.4g})")
    e_plain = float((g - p).abs().max())
    e_ref = float((g - r).abs().max())
    if e_plain > limit or e_ref > limit:
        fail(f"{what}: max abs err {e_plain:.4g} vs plain, {e_ref:.4g} vs "
             f"reference exceeds {limit:.4g}")
    return e_plain, e_ref, limit


def trace(fn, torch, calls: int = 3, want=()) -> list:
    """(name, device us, launches) of each CUDA kernel in a
    torch.profiler trace of ``calls`` calls of ``fn``, after one call
    that is not traced.  Later in a process's life the profiler may see
    no kernel in every other session, and some sessions see only part of
    them, so up to TRACES traces, each a profiler session of its own,
    until one shows a kernel and every name in ``want``; [] when none
    showed a kernel."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    for _ in range(TRACES):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
        seen = []
        for e in prof.key_averages():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            us = getattr(e, "self_device_time_total", None) or \
                getattr(e, "device_time_total", 0.0)
            if us > 0 and e.count:
                seen.append((e.key, us, e.count))
        if seen:
            out = seen
            if all(any(w in key for key, _, _ in seen) for w in want):
                break
    return out


def device_breakdown(fn, torch, calls: int = 3, want=()) -> str:
    """Mean device time per launch of each CUDA kernel ``fn`` launches,
    from torch.profiler (each kernel's total over its own launch count)
    over ``calls`` calls; "not measured" when the profiler sees no
    device time."""
    parts = [f"{name} {ms:.4f} ms x{count}"
             for name, ms, count in device_kernels(fn, torch, calls, want)]
    return ", ".join(parts) if parts else "not measured"


def device_kernels(fn, torch, calls: int = 3, want=()) -> list:
    """(name, mean device ms per launch, launches) of each CUDA kernel
    ``fn`` launches over ``calls`` traced calls (``trace``)."""
    parts = []
    for key, us, count in trace(fn, torch, calls, want):
        name = key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("::")[-1][:40]
        parts.append((name, us / count / 1e3, count))
    return parts


def one_kernel(label: str, fn, kernel: str, torch, calls: int = 5) -> None:
    """Trace ``calls`` calls of ``fn`` and fail unless the trace shows
    ``kernel`` and no other kernel (no combine, no memset): with the
    wrapper's launch count (one a call), one kernel a call.  When the
    tracer sees no kernel in any of its TRACES traces the check cannot be
    made, and the script says so ("not measured") and goes on: the
    kernel's time is the CUDA-event time printed before.  Prints the
    kernel's device ms per launch."""
    seen = device_kernels(fn, torch, calls, (kernel,))
    print(f"[{label}] device time per call: " + (", ".join(
        f"{name} {ms:.4f} ms x{count}" for name, ms, count in seen)
        or f"not measured (the tracer saw no kernel in {TRACES} traces)")
        + f" ({calls} calls traced)")
    if seen and (len(seen) != 1 or kernel not in seen[0][0]
                 or not 1 <= seen[0][2] <= calls):
        fail(f"{label}: expected {kernel} alone, at most once a call, in "
             f"the trace of {calls} calls; it shows {seen}")


def aba(label: str, run, plain, a, b, same, torch) -> None:
    """Calls A, B, A back to back on different inputs (``a``, ``b``), no
    synchronisation between: each as its plain version (``same(got,
    want, what)``), and the two A calls bitwise equal; a flag word left
    by the call before would shift a prefix or a partial."""
    outs = [run(a), run(b), run(a)]
    torch.cuda.synchronize()
    for got, inp, what in zip(outs, (a, b, a), ("A", "B", "A again")):
        same(got, plain(inp), f"{label} call {what}")
    first, third = (o if isinstance(o, tuple) else (o,)
                    for o in (outs[0], outs[2]))
    if not all(torch.equal(u, v) for u, v in zip(first, third)):
        fail(f"{label}: calls A and A again (after B) differ")
    print(f"[{label}] A/B/A: each call as its plain version, A twice "
          "bitwise equal")


def pipeline_ops(name: str, inputs) -> int:
    """Floating-point operations the pipeline's bodies do on these
    inputs (compares and conversions counted as one each)."""
    if name == "tpchq6":
        return 5 * inputs["qty"].shape[0]          # 2 cmp, and, mul, add
    if name == "gda":
        n, d = inputs["pts"].shape
        return n * (d * d + d + d * d)             # outer, sums
    if name == "kmeans":
        n, d = inputs["points"].shape
        k = inputs["centroids"].shape[0]
        return n * (3 * k * d + k + d + 1)         # distances, argmin, sums
    if name == "gda_moments":
        n, d = inputs["pts"].shape
        return n * 4 * d                           # weight, square, 2 sums
    if name == "normalize":
        n, d = inputs["x"].shape
        return n * (3 * d + 2)                     # squares, sum, rsqrt, scale
    raise KeyError(name)


def filter_program(n: int):
    """The paper's Table 2 filter, x.flatMap{e => if (e > 0) [e] else
    []}, as one FlatMap over n randn rows (seed 11).  Returns the
    SUITE-builder tuple ``(pattern, sizes, make_inputs, reference)``."""
    import torch
    from repro_torch.core import ir

    x = ir.Tensor("x", (n,))
    p = ir.FlatMap(
        domain=(n,), max_per_iter=1, reads=(ir.elem(x),),
        fn=lambda s, e: (e[..., None], (e > 0).to(torch.int32)),
        cuda="out[0] = in0[0];\ncount = in0[0] > 0.0f ? 1 : 0;", name="f")

    def make_inputs():
        return {"x": np.random.RandomState(11).randn(n).astype(np.float32)}

    def reference(inp):
        return inp["x"][inp["x"] > 0]

    return p, None, make_inputs, reference


def bound(nbytes: int, ops: int, tier, peak=None) -> tuple:
    """(bound ms, what bounds it): bytes over the card's memory rate
    against operations over its fp32 rate (or ``peak`` FLOP/s)."""
    bytes_ms = nbytes / tier.hbm_bytes_per_s * 1e3
    ops_ms = ops / (peak or tier.peak_flops) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def dag_forms(label: str, spec) -> None:
    """Print each CAM terminal's form and column slots, and the CAM
    staging beside the plan's charge; fail unless every CAM terminal took
    the register form."""
    cams = [(t.name, t.cam_form, t.cam_lanes) for t in spec.terminals
            if t.kind == "cam"]
    print(f"[{label}] CAM terminals (name, form, column slots): {cams}; "
          f"shared bytes {spec.onchip_bytes} charged + {spec.staging_bytes} "
          f"staging = {spec.smem_bytes}")
    off = [name for name, form, _ in cams if form != "register"]
    if off:
        fail(f"{label}: CAM terminal(s) {off} did not take the register form")


def same_bits(label: str, first: dict, second: dict, torch) -> None:
    """Two calls' outputs, name by name, bitwise equal."""
    for k, v in first.items():
        if not torch.equal(v, second[k]):
            fail(f"{label}: two calls differ in {k} (max abs diff "
                 f"{float((v - second[k]).abs().max()):.3e})")
    print(f"[{label}] two calls bitwise equal: {sorted(first)}")


def dag_breakdown(label: str, fn, spec, torch) -> None:
    """Print the device time of the fused-DAG kernel and, where the DAG
    has partials, of combine_partials (``breakdown``)."""
    breakdown(label, fn, ["fused_dag_kernel"] + (
        ["combine_partials"] if spec.partial_words else []), torch)


def breakdown(label: str, fn, want, torch) -> None:
    """Print the device time of each kernel ``fn`` launches; the profiler
    may drop a kernel of a trace (``trace``); fail if the tracer saw
    kernels but one of those named in ``want`` stays unmeasured (a
    tracer that sees no kernel at all is "not measured", as in
    ``one_kernel``)."""
    parts = device_breakdown(fn, torch, want=want)
    missing = [k for k in want if k not in parts]
    print(f"[{label}] device time per call: {parts}")
    if missing and parts != "not measured":
        fail(f"{label}: device time of {missing} not measured")


def run_outerprod(call, make_inputs, reference, cc, tier, torch) -> dict:
    """lower_auto(outerprod) through the tiled-Map kernel: bitwise
    against its plain version and torch.outer on the card, and against
    numpy on CHECK_ROWS rows (one IEEE multiply per word in each)."""
    host = make_inputs()
    env = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    torch.cuda.synchronize()
    cc.tiled_map.launches = 0
    out = call(**env)
    torch.cuda.synchronize()
    launches = cc.tiled_map.launches
    spec = call.kernel.spec
    print(f"[outerprod] m=n={OUTER_N} grid={spec.grid} tile={spec.domain} "
          f"depth={spec.depth} tiled_map launches={launches}")
    if launches < 1:
        fail("outerprod: tiled_map was not launched")
    if tuple(out.shape) != (OUTER_N, OUTER_N) or not bool(
            torch.isfinite(out).all()):
        fail("outerprod: output not finite of shape (m, n)")
    plain = cc.tiled_map_plain(spec, env)
    err = float((out - plain).abs().max())
    lib = torch.outer(env["x"], env["y"])
    if not torch.equal(out, plain) or not torch.equal(out, lib):
        fail(f"outerprod: not bitwise equal to the plain version (max abs "
             f"err {err:.3e}) or torch.outer")
    rows = slice(0, CHECK_ROWS)
    want = reference({"x": host["x"][rows], "y": host["y"]})
    if not np.array_equal(out[rows].cpu().numpy(), want):
        fail("outerprod: not bitwise equal to numpy on the checked rows")
    del plain, lib
    print(f"[outerprod] bitwise equal to plain, torch.outer and numpy "
          f"({CHECK_ROWS} rows)")
    kern = call.kernel
    ms = median_ms(lambda: cc.tiled_map(kern, env), torch)
    plain_ms = median_ms(lambda: cc.tiled_map_plain(spec, env), torch)
    lib_ms = median_ms(lambda: torch.outer(env["x"], env["y"]), torch)
    nbytes = (2 * OUTER_N + OUTER_N * OUTER_N) * 4
    bound_ms, by = bound(nbytes, OUTER_N * OUTER_N, tier)
    print(f"[outerprod] tiled_map {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.outer {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes} B)", flush=True)
    print("[outerprod] device time per call: " + device_breakdown(
        lambda: cc.tiled_map(kern, env), torch))
    return {"name": "tiled_map[outerprod]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tiled_map.cuh",
            "replaces": f"{REPLACES}:128", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


def run_gda(call, make_inputs, reference, cc, tier, torch, dev) -> dict:
    """lower_auto(gda) through the CAM (the fused-DAG kernel with one CAM
    terminal): within SUM_RTOL of the float64 reference and of the plain
    version, after proving that limit tighter than the planted faults."""
    from repro_torch.patterns.analytics import gda

    host = make_inputs()
    env = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    torch.cuda.synchronize()
    cc.fused_dag.launches = 0
    out = call(**env)
    torch.cuda.synchronize()
    launches = cc.fused_dag.launches
    kern = call.kernel
    spec = kern.spec
    print(f"[gda] n={ROWS} block={spec.block} grid={spec.grid} depth="
          f"{spec.depth} ctas={kern.ctas(dev)} fused_dag launches={launches}")
    if launches < 1:
        fail("gda: the CAM kernel was not launched")
    dag_forms("gda", spec)
    same_bits("gda", {"gda": out}, {"gda": call(**env)}, torch)
    plain = cc.fused_dag_plain(spec, env)["gda"]
    shifts = fault_shifts(lambda rows: gda(n=rows)[3], host, ROWS,
                          spec.block, spec.grid, kern.ctas(dev), ["gda"])
    e_plain, e_ref, limit = check_sum("gda", out, plain, reference(host),
                                      shifts, torch, "gda")
    print(f"[gda] max abs err vs plain {e_plain:.6g}, vs reference "
          f"{e_ref:.6g}; limit {limit:.6g}; planted faults shift it by "
          + ", ".join(f"{by['gda']:.6g} ({f})" for f, by in shifts.items()))
    ms = median_ms(lambda: cc.fused_dag(kern, env), torch)
    plain_ms = median_ms(lambda: cc.fused_dag_plain(spec, env), torch)
    n, d = host["pts"].shape
    k, ew = out.shape
    nbytes = (n * d + n + k * ew) * 4
    bound_ms, by = bound(nbytes, n * (d * d + ew), tier)
    print(f"[gda] CAM {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes} B)", flush=True)
    dag_breakdown("gda", lambda: cc.fused_dag(kern, env), spec, torch)
    return {"name": "tiled_groupby[gda]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_dag.cuh",
            "replaces": f"{REPLACES}:230", "launches": launches,
            "max_abs_err": e_plain, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


def run_filter(call, make_inputs, reference, cc, tier, torch, dev) -> dict:
    """lower_auto(filter) through the tiled-FlatMap kernel: the count
    exact and the buffer bitwise against its plain version and against
    numpy's x[x > 0], the tail past the count zero; calls A, B, A on two
    inputs each as the plain version; one kernel launch a call.  No
    library time: no single PyTorch call makes the zero-padded buffer
    and the count (x[x > 0] makes neither)."""
    host = make_inputs()
    env = {"x": torch.as_tensor(host["x"]).cuda()}
    torch.cuda.synchronize()
    cc.tiled_flatmap.launches = 0
    buf, count = call(**env)
    torch.cuda.synchronize()
    launches = cc.tiled_flatmap.launches
    kern = call.kernel
    spec = kern.spec
    print(f"[filter] n={TPCH_ROWS} grid={spec.grid} tile={spec.domain} "
          f"depth={spec.depth} tiled_flatmap launches={launches}")
    if launches < 1:
        fail("filter: tiled_flatmap was not launched")
    want = reference(host)
    p_buf, p_count = cc.tiled_flatmap_plain(spec, env)
    got = int(count)
    err = float((buf - p_buf).abs().max())
    if got != int(p_count) or got != want.size:
        fail(f"filter: count {got}, plain {int(p_count)}, numpy {want.size}")
    if not torch.equal(buf, p_buf):
        fail(f"filter: buffer not bitwise equal to plain (max abs err "
             f"{err:.3e})")
    if not np.array_equal(buf[:got].cpu().numpy(), want) \
            or bool(buf[got:].any()):
        fail("filter: values differ from x[x > 0] or the tail is not zero")
    print(f"[filter] count {got} exact; buffer bitwise equal to plain and "
          f"x[x > 0]; tail zero; shared bytes {spec.onchip_bytes} charged + "
          f"{spec.scan_bytes} scan = {spec.smem_bytes}; {kern.ctas(dev)} "
          f"blocks for {spec.steps} tiles")
    other = {"x": torch.as_tensor(np.random.RandomState(12).randn(
        TPCH_ROWS).astype(np.float32)).cuda()}

    def same(out, want, what):
        if int(out[1]) != int(want[1]) or not torch.equal(out[0], want[0]):
            fail(f"{what}: count {int(out[1])} vs plain {int(want[1])}, or "
                 "the buffer not bitwise equal to plain")

    aba("filter", lambda e: call(**e),
        lambda e: cc.tiled_flatmap_plain(spec, e), env, other, same, torch)
    del other
    ms = median_ms(lambda: cc.tiled_flatmap(kern, env), torch)
    plain_ms = median_ms(lambda: cc.tiled_flatmap_plain(spec, env), torch)
    nbytes = 2 * TPCH_ROWS * 4 + 4    # x read, buffer written, the count
    bound_ms, by = bound(nbytes, TPCH_ROWS, tier)
    print(f"[filter] tiled_flatmap {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes} B)", flush=True)
    one_kernel("filter", lambda: cc.tiled_flatmap(kern, env),
               "flatmap_kernel", torch)
    issue = host_ms(lambda: cc.tiled_flatmap(kern, env), torch)
    print(f"[filter] host {issue:.4f} ms a call to issue")
    return {"name": "tiled_flatmap[filter]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tiled_flatmap.cuh",
            "replaces": f"{REPLACES}:295", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


# ------------------------------------------------ the tiled GEMM template
GEMM_TPU = f"{REPLACES}:177"
GEMM_PR12_MS = 4.468         # 64x64x64 before the metapipeline (PERF.md)


def gemm_faults(x, y, want, bk: int, depth: int, torch) -> list:
    """The GEMM's planted faults on the float64 reference rows ``want``
    (``x``'s first rows times ``y``): the middle K slab dropped, and a
    stale ring slot (slab ``depth`` computed from the slot of slab 0,
    the one it reuses; only where K has more than ``depth`` slabs, so
    that a slot is reused).  Fails unless rtol = atol = RTOL catches
    each; returns their descriptions with the shift."""
    rows = want.shape[0]
    xd, yd = x[:rows].double(), y.double()

    def slab(i):
        return xd[:, i * bk:(i + 1) * bk] @ yd[i * bk:(i + 1) * bk]
    mid = x.shape[1] // bk // 2
    faults = [(f"K slab {mid} dropped", want - slab(mid))]
    if x.shape[1] // bk > depth:
        faults.append((f"slab {depth} read from slab 0's slot",
                       want - slab(depth) + slab(0)))
    out = []
    for what, faulted in faults:
        shift = float((faulted - want).abs().max())
        if torch.allclose(faulted, want, rtol=RTOL, atol=ATOL):
            fail(f"gemm: rtol/atol {RTOL}/{ATOL} would not catch {what}")
        out.append(f"{what} shifts it by {shift:.4g}")
    return out


def run_tiled_gemm(label: str, call, x, y, host, gtile, depth: int, cc,
                   tier, torch) -> dict:
    """``lower(tile(gemm), depth=...)`` at 4096^3 float32 through the
    GEMM template: its layout, against the plain version, torch.matmul
    (TF32 off) and the float64 reference on 64 rows after proving that
    limit catches the planted faults; timed beside both."""
    bm, bn, bk = gtile
    lay = cc.gemm_layout(bm, bn, bk, depth)
    torch.cuda.synchronize()
    cc.tiled_gemm.launches = 0
    out = call(x=x, y=y)
    torch.cuda.synchronize()
    launches = cc.tiled_gemm.launches
    print(f"[{label}] m=n=k={GEMM_N} tile_plan={call.tile_plan}: "
          f"{lay.tm}x{lay.tn} micro-tile, {lay.threads} threads, "
          f"{lay.smem_bytes} B of shared memory ({lay.pad_bytes} B of it "
          f"padding); tiled_gemm launches={launches}")
    if launches < 1:
        fail(f"{label}: tiled_gemm was not launched")
    e_plain = max_err(out, cc.tiled_gemm_plain(x, y, bm=bm, bn=bn, bk=bk),
                      torch, f"{label} vs plain")
    e_lib = max_err(out, torch.matmul(x, y), torch,
                    f"{label} vs torch.matmul")
    want = torch.as_tensor(host["x"][:64].astype("float64")
                           @ host["y"].astype("float64"), device=x.device)
    faults = gemm_faults(x, y, want, bk, depth, torch)
    e_ref = max_err(out[:64], want, torch, f"{label} vs reference rows")
    print(f"[{label}] max abs err vs plain {e_plain:.3e}, vs torch.matmul "
          f"{e_lib:.3e}, vs float64 reference (64 rows) {e_ref:.3e} "
          f"(rtol/atol {RTOL}/{ATOL}); planted faults caught: "
          + "; ".join(faults))

    def run():
        return cc.tiled_gemm(x, y, bm=bm, bn=bn, bk=bk, depth=depth)
    ms = median_ms(run, torch)
    plain_ms = median_ms(
        lambda: cc.tiled_gemm_plain(x, y, bm=bm, bn=bn, bk=bk), torch)
    lib_ms = median_ms(lambda: torch.matmul(x, y), torch)
    flops = 2 * GEMM_N ** 3
    bound_ms, by = bound(nbytes_of(x, y, out), flops, tier)
    print(f"[{label}] device time per call: " + device_breakdown(run, torch))
    print(f"[{label}] tiled_gemm {ms:.4f} ms ({flops / ms / 1e9:.2f} "
          f"TFLOP/s; 64x64x64 before the metapipeline: {GEMM_PR12_MS} ms), "
          f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by})", flush=True)
    return {"name": label, "route": "cuda", "source": f"{CSRC}/tiled_gemm.cuh",
            "replaces": GEMM_TPU, "launches": launches,
            "max_abs_err": e_plain, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


def run_auto_gemm(call, x, y, host, cc, tier, torch) -> dict:
    """``lower_auto(gemm)`` of SUITE at 4096^3 float32 (TF32 off): the
    DSE's plan in the template's own space (``dse.template_kernel``), its
    charge beside the bytes the template allocates at that tile
    (``gemm_layout``, which the library checks), one launch a call, then
    ``run_tiled_gemm``'s checks: the plain version, the planted faults,
    torch.matmul and the bound."""
    plan = call.tile_plan
    (bm, bn), (bk,) = plan.sizes["gemm"], plan.sizes["gemm_k"]
    lay = cc.gemm_layout(bm, bn, bk, plan.depth)
    print(f"[lower_auto[gemm]] plan: sizes={plan.sizes} depth={plan.depth} "
          f"explored={plan.explored} pruned={plan.pruned}; charged "
          f"{plan.vmem_bytes} B, the template allocates {lay.smem_bytes} B",
          flush=True)
    if plan.vmem_bytes != lay.smem_bytes:
        fail(f"lower_auto[gemm]: the plan charges {plan.vmem_bytes} B, the "
             f"template allocates {lay.smem_bytes} B")
    torch.cuda.synchronize()
    cc.tiled_gemm.launches = 0
    call(x=x, y=y)
    torch.cuda.synchronize()
    if cc.tiled_gemm.launches != 1:
        fail(f"lower_auto[gemm]: {cc.tiled_gemm.launches} tiled_gemm "
             "launches in one call")
    print("[lower_auto[gemm]] tiled_gemm launches in one call: 1")
    return run_tiled_gemm("lower_auto[gemm]", call, x, y, host, (bm, bn, bk),
                          plan.depth, cc, tier, torch)


# ------------------------------------------------ what the kernels compiled to
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "FFMA", "ATOMS", "ATOMG",
            "ATOM", "RED")
# the kernels of each library by variant: (label, function-name key, the
# instructions it must have, the instructions it must not have)
ATOMICS = ("ATOMS", "ATOMG", "ATOM", "RED")
HGMMA = ("HGMMA",)
TENSOR_CORES = ("HMMA", "HGMMA")
# ssd_scan: the scores, states and output passes stage B, C and x by
# cp.async into FFMA; no pass uses the tensor cores in either type (rule A
# would let the bf16 scores onto them; this design keeps them on FFMA so
# that a bf16 call is the f32 call on widened inputs)
SSD_SASS = tuple(
    (f"ssd_scan[{p},{t}]", f"{p}_kernelI{key}", ("LDGSTS", "FFMA"),
     TENSOR_CORES)
    for p in ("scores", "states", "output")
    for t, key in (("f32", "f"), ("bf16", "13__nv_bfloat16"))) + (
    ("ssd_scan[carry]", "carry_kernel", (), TENSOR_CORES),)
SASS_VARIANTS = {
    "matmul": (("matmul[wgmma]", "wgmma_kernel", HGMMA, ()),
               ("matmul[ffma]", "ffma_kernel", (), ())),
    "flash_attention": (("flash_attention[wgmma]", "wgmma_kernel", HGMMA, ()),
                        ("flash_attention[ffma]", "ffma_kernel", (), ()),
                        ("flash_attention[combine]", "combine_kernel", (),
                         ())),
    "paged_decode": (("paged_decode[attend,bf16 pool]",
                      "attend_kernelI13__nv_bfloat16", ("LDGSTS",), ()),
                     ("paged_decode[attend,f32 pool]", "attend_kernelIf",
                      ("LDGSTS",), ()),
                     ("paged_decode[combine]", "combine_kernel", (), ())),
    "ssd_scan": SSD_SASS,
    # the one-launch kernels: a cp.async ring, flag words without atomics
    "filter_fold": (("filter_fold[plain]", "filter_fold_kernelILb0E",
                     ("LDGSTS",), ATOMICS),
                    ("filter_fold[staged]", "filter_fold_kernelILb1E",
                     ("LDGSTS",), ATOMICS)),
    "lower_auto[filter]": (("tiled_flatmap[filter]", "flatmap_kernel",
                            ("LDGSTS",), ATOMICS),),
}
# libraries whose ptxas report must show no stack frame, beside the fused
# DAG and the keyed kernels
NO_STACK = ("filter_fold", "lower_auto[filter]")
# the GEMM template, one library per tile: cp.async slabs into FFMA
GEMM_SASS = (("LDGSTS", "FFMA"), HGMMA)
# the fused-DAG template, one library per DAG and plan: streamed tiles by
# cp.async, CAM and fold sums without any atomic (shared, global or RED)
DAG_SASS = (("fused_dag_kernel", ("LDGSTS",), ATOMICS),
            ("combine_partials", (), ATOMICS))


def is_dag(lib: str) -> bool:
    """A label of a fused-DAG library (chip_smoke's pipelines and the
    CAM of ``lower_auto[gda]``)."""
    return lib.startswith("fused_dag[") or lib == "lower_auto[gda]"


def is_keyed(lib: str) -> bool:
    """A label of a keyed hand kernel's library (``keyed_libraries``)."""
    return lib.startswith(("fused_kmeans[", "groupby_fold["))


def sass_variants(lib: str) -> tuple:
    if lib in SASS_VARIANTS:
        return SASS_VARIANTS[lib]
    if is_dag(lib):
        return tuple((f"{lib}:{key}", key, must, must_not)
                     for key, must, must_not in DAG_SASS)
    if is_keyed(lib):
        # fused_kmeans streams its points by cp.async; groupby_fold reads
        # rows straight from global memory
        key, must = (("kmeans_kernel", ("LDGSTS",))
                     if lib.startswith("fused_kmeans") else ("gbf", ()))
        return ((lib, key, must, ATOMICS),
                (f"{lib}:combine_partials", "combine_partials", (), ATOMICS))
    return ((lib, "tiled_gemm_kernel") + GEMM_SASS,)


def sass_check(paths: dict) -> None:
    """Counts HGMMA (wgmma), UTMALDG (TMA loads), LDGSTS (cp.async), FFMA
    and the atomics (ATOMS, ATOMG, ATOM, RED) in the SASS of each variant
    of the libraries in ``paths`` (name
    -> built library), read with ``cuobjdump -sass``; fails if cuobjdump
    is missing, or a variant lacks an instruction it must have or has
    one it must not (``SASS_VARIANTS``; a ``tiled_gemm[...]`` library:
    ``GEMM_SASS``; a fused-DAG library: ``DAG_SASS``)."""
    import os

    exe = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" \
        / "cuobjdump"
    if not exe.exists():
        fail(f"SASS check: {exe} not found")
    op = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for lib, path in paths.items():
        variants = sass_variants(lib)
        text = subprocess.run([str(exe), "-sass", str(path)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {label: dict.fromkeys(SASS_OPS, 0) for label, *_ in
                  variants}
        functions = {label: 0 for label, *_ in variants}
        current = None
        for line in text.splitlines():
            if "Function :" in line:
                name = line.split("Function :", 1)[1].strip()
                current = next((label for label, key, *_ in variants
                                if key in name), None)
                if current:
                    functions[current] += 1
            elif current:
                for hit in op.findall(line):
                    counts[current][hit] += 1
        for label, _, must, must_not in variants:
            c = counts[label]
            print(f"[sass] {label}: {functions[label]} instantiations; "
                  + ", ".join(f"{k} {v}" for k, v in c.items()), flush=True)
            if not functions[label]:
                fail(f"SASS check: no {label} kernel in {path}")
            for k in must:
                if not c[k]:
                    fail(f"SASS check: {label} has no {k} instruction")
            for k in must_not:
                if c[k]:
                    fail(f"SASS check: {label} has {c[k]} {k} instructions")


# ------------------------------------------------ hand-written kernels
def show_plan(label: str, kind: str, *shape, dev) -> None:
    from repro_torch.kernels import ops
    blocks, plan = ops.resolve_plan(kind, *shape, device=dev)
    print(f"[{label}] DSE plan for {kind}{shape}: blocks={blocks} depth="
          f"{plan.depth} onchip_bytes={plan.vmem_bytes}", flush=True)


def nbytes_of(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def run_matmul(label: str, run, x, y, tol: float, peak, tier, torch) -> dict:
    """One ``matmul`` entry point at 4096^3: against its plain version,
    torch.matmul (TF32 off) and a float64 product of 64 rows."""
    from repro_torch.kernels import matmul as mm

    which = mm.variant(x.dtype, y.dtype, x.shape[1], y.shape[1])
    torch.cuda.synchronize()
    mm.matmul.launches = mm.matmul.wgmma_launches = 0
    mm.matmul.ffma_launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = mm.matmul.launches
    ran = {"wgmma": mm.matmul.wgmma_launches,
           "ffma": mm.matmul.ffma_launches}
    print(f"[{label}] {tuple(x.shape)} x {tuple(y.shape)} {x.dtype} -> "
          f"{out.dtype}; matmul launches={launches} (wgmma {ran['wgmma']}, "
          f"ffma {ran['ffma']})")
    if launches < 1:
        fail(f"{label}: the matmul kernel was not launched")
    if ran[which] != launches:
        fail(f"{label}: expected every launch to run the {which} kernel")
    e_plain = max_err(out, mm.matmul_plain(x, y, out.dtype), torch,
                      f"{label} vs plain", tol)
    e_lib = max_err(out, torch.matmul(x, y), torch,
                    f"{label} vs torch.matmul", tol)
    want = x[:64].double().cpu() @ y.double().cpu()
    e_ref = max_err(out[:64], want, torch, f"{label} vs float64 rows", tol)
    print(f"[{label}] max abs err vs plain {e_plain:.3e}, vs torch.matmul "
          f"{e_lib:.3e}, vs float64 (64 rows) {e_ref:.3e} (rtol/atol {tol})")
    ms = median_ms(run, torch)
    plain_ms = median_ms(lambda: mm.matmul_plain(x, y, out.dtype), torch)
    lib_ms = median_ms(lambda: torch.matmul(x, y), torch)
    flops = 2 * x.shape[0] * x.shape[1] * y.shape[1]
    bound_ms, by = bound(nbytes_of(x, y, out), flops, tier, peak)
    print(f"[{label}] matmul {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), "
          f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by})", flush=True)
    print(f"[{label}] device time per call: " + device_breakdown(run, torch))
    return {"name": label, "route": "cuda", "source": f"{CSRC}/matmul.cuh",
            "replaces": f"{HAND}/matmul.py:49", "launches": launches,
            "max_abs_err": e_plain, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


def q6_inputs(n: int, seed: int = 12) -> dict:
    """TPC-H Q6's two lineitem columns (``seed``): l_discount drawn from
    {0.00, 0.01, ..., 0.10} and an l_extendedprice-like value uniform in
    [901, 104,950] (SF1's range), both float32."""
    rng = np.random.RandomState(seed)
    return {"x": (rng.randint(0, 11, n) / 100).astype(np.float32),
            "w": rng.uniform(901.0, 104950.0, n).astype(np.float32)}


def q6_reference(inp) -> np.ndarray:
    """The Q6 sum in float64 over the float32 products, the bounds
    compared in float32."""
    x, w = inp["x"], inp["w"]
    pred = (x >= np.float32(Q6_LO)) & (x < np.float32(Q6_HI))
    return np.float64(np.where(pred, x * w, np.float32(0)).sum(
        dtype=np.float64))


def keyed_reference(keys: np.ndarray, values: np.ndarray, k: int):
    """Float64 keyed sums of a (t, E) values array, keys outside [0, k)
    dropped."""
    keep = (keys >= 0) & (keys < k)
    return np.stack([np.bincount(keys[keep], weights=values[keep, e]
                                 .astype(np.float64), minlength=k)
                     for e in range(values.shape[1])], 1)


def run_folded(label: str, key: str, run, plain, ref, reference_at, host,
               block: int, fn, library, nbytes: int, ops: int, source: str,
               replaces: str, tier, torch, kernel: str = "",
               one_launch: bool = False, lane_rows: int = 1,
               piece: int = 0) -> dict:
    """One persistent hand-written kernel whose outputs are sums: the
    launch count, two calls bitwise equal, the sums (and counts exactly)
    against its plain version and the float64 reference after the
    planted-fault proof (``lane_rows`` and ``piece`` say which rows a
    warp owns: ``fault_shifts``), then its times beside its plain
    version's and the library call's.  With ``kernel`` (a kernel's name)
    the device times of that kernel and of combine_partials must be
    measured; with ``one_launch`` too, the trace must show that kernel
    alone, once a call."""
    torch.cuda.synchronize()
    fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = fn.launches
    print(f"[{label}] block={block} steps={host_rows(host) // block} "
          f"ctas={fn.ctas} launches={launches}")
    if launches < 1:
        fail(f"{label}: the kernel was not launched")
    names = list(ref) if isinstance(ref, dict) else [key]

    def named(v) -> dict:   # a kernel's tuple of outputs, in ref's order
        return dict(zip(names, v)) if isinstance(v, tuple) \
            else as_outputs(v, names)

    outs, plains, refs = named(out), named(plain()), as_outputs(ref, names)
    same_bits(label, outs, named(run()), torch)
    shifts = fault_shifts(reference_at, host, host_rows(host), block,
                          host_rows(host) // block, fn.ctas, names,
                          lane_rows, piece)
    e_plain = 0.0
    for k in names:
        ep, er, limit = check_sum(k, outs[k], plains[k], refs[k], shifts,
                                  torch, f"{label}/{k}")
        e_plain = max(e_plain, ep)
        print(f"[{label}] {k}: max abs err vs plain {ep:.6g}, vs reference "
              f"{er:.6g}; limit {limit:.6g}; planted faults shift it by "
              + ", ".join(f"{by[k]:.6g} ({f})" for f, by in shifts.items()))
    ms = median_ms(run, torch)
    plain_ms = median_ms(plain, torch)
    lib_ms = median_ms(library, torch) if library else None
    bound_ms, by = bound(nbytes, ops, tier)
    print(f"[{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
          f"{bound_ms:.4f} ms ({nbytes} B, {ops} ops)", flush=True)
    if kernel and one_launch:
        one_kernel(label, run, kernel, torch)
        print(f"[{label}] host {host_ms(run, torch):.4f} ms a call to issue")
    elif kernel:
        breakdown(label, run, [kernel, "combine_partials"], torch)
    else:
        print(f"[{label}] device time per call: "
              + device_breakdown(run, torch))
    return {"name": label, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": e_plain, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


def host_rows(host: dict) -> int:
    return max(v.shape[0] for v in host.values())


def keyed_form(label: str, num_keys: int, ew: int, dev, torch) -> str:
    """Print the form ``groupby_fold.table_form`` gives a table on this
    card, its column slots or row groups and its shared bytes; returns
    the form."""
    from repro_torch.kernels import groupby_fold as gbf

    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    form, groups = gbf.table_form(num_keys, ew, optin)
    if form == "register":
        how, smem = "P = 1 (each lane adds its own row)", 4 * num_keys * ew
    else:
        how = f"{groups} row groups of {32 // groups} lanes a warp"
        smem = gbf.shared_bytes(num_keys, ew, groups)
    print(f"[{label}] form {form}: {how}; shared bytes per block {smem}")
    return form


def ran_form(label: str, ran: str, want: str) -> None:
    if ran != want:
        fail(f"{label}: the {ran} form ran, the rule gives {want}")


def kmeans_forms() -> tuple:
    """The sums' column slots P of ``fused_kmeans`` at chip_smoke's shape:
    the rule's (``kmeans_lanes``), then the other form measured beside
    it (the fused DAG's ``cam_forms`` choice for the sums beside the
    counts, or P = 1)."""
    from repro_torch.core.codegen_cuda import cam_forms
    from repro_torch.kernels.fused_kmeans import kmeans_lanes

    p = kmeans_lanes(8, 16)
    return p, (cam_forms([(8, 16), (8, 1)])[0][1] if p == 1 else 1)


def keyed_libraries(dev, torch) -> list:
    """(label, library) of each instantiation of the keyed kernels the
    hand-kernel phases run: ``groupby_fold`` at 64 x 8 and at the
    router's 8 x 1, ``fused_kmeans`` at both forms of ``kmeans_forms``,
    each at the DSE's plan for the card, and ``groupby_fold`` at
    Llama-4's 128 experts at ``ops.groupby``'s block (the ``[moe]``
    phase's router)."""
    from repro_torch.kernels import fused_kmeans as fkm
    from repro_torch.kernels import groupby_fold as gbf
    from repro_torch.kernels import ops

    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    out = []
    for label, k, ew in (("groupby_fold[64x8]", 64, 8),
                         ("groupby_fold[router]", 8, 1)):
        block = ops.resolve_plan("groupby", ROWS, k, ew, device=dev)[0]
        out.append((label, gbf.library(k, ew, block,
                                       *gbf.table_form(k, ew, optin))))
    # Llama-4's router through moe.router_counts: ops.groupby's block
    out.append((ROUTER_LABEL, gbf.library(MOE_EXPERTS, 1, 256, *gbf.table_form(
        MOE_EXPERTS, 1, optin))))
    block, plan = ops.resolve_plan("fused_kmeans", ROWS, 8, 16, device=dev)
    for lanes in kmeans_forms():
        out.append((f"fused_kmeans[P={lanes}]",
                    fkm.library(8, 16, block, plan.depth, lanes)))
    return out


def run_hand_kernels(kmeans_kernel, cc, tier, torch, dev) -> list:
    """The hand-written kernels through their entry points, on the card
    at full size."""
    from repro_torch.kernels import autotile, ops
    from repro_torch.kernels import filter_reduce as fr
    from repro_torch.kernels import fused_filter_fold as fff
    from repro_torch.kernels import fused_kmeans as fkm
    from repro_torch.kernels import groupby_fold as gbf
    from repro_torch.kernels import matmul as mm
    from repro_torch.patterns.analytics import gemm, kmeans_pipeline

    rows = []
    # ---- matmul: default blocks, the DSE's plan, bfloat16
    host = gemm(GEMM_N, GEMM_N, GEMM_N)[2]()
    x = torch.as_tensor(host["x"]).to(dev)
    y = torch.as_tensor(host["y"]).to(dev)
    print("[matmul[f32]] fixed blocks (128, 128, 128), matmul's defaults")
    rows.append(run_matmul("matmul[f32]", lambda: mm.matmul(x, y), x, y,
                           RTOL, None, tier, torch))
    show_plan("matmul[f32,auto]", "gemm", GEMM_N, GEMM_N, GEMM_N, dev=dev)
    rows.append(run_matmul("matmul[f32,auto]",
                           lambda: autotile.tuned_matmul(x, y), x, y, RTOL,
                           None, tier, torch))
    xb, yb = x.bfloat16(), y.bfloat16()
    del x, y
    print("[matmul[bf16]] fixed blocks (128, 128, 128), matmul's defaults")
    rows.append(run_matmul("matmul[bf16]", lambda: mm.matmul(xb, yb), xb, yb,
                           BF16_TOL, BF16_PEAK, tier, torch))
    del xb, yb

    # ---- TPC-H Q6 through both filter-fold kernels: one launch a call
    host = q6_inputs(TPCH_ROWS)
    x, w = (torch.as_tensor(host[k]).to(dev) for k in ("x", "w"))
    ref = q6_reference(host)
    other = q6_inputs(TPCH_ROWS, seed=13)
    xb, wb = (torch.as_tensor(other[k]).to(dev) for k in ("x", "w"))
    for label, kind, fn, plain, src_line in (
            ("filter_reduce", "filter_reduce", fr.filter_reduce,
             fr.filter_reduce_plain, "filter_reduce.py:41"),
            ("fused_filter_fold", "fused_filter_fold", fff.fused_filter_fold,
             fff.fused_filter_fold_plain, "fused_filter_fold.py:48")):
        show_plan(label, kind, TPCH_ROWS, dev=dev)
        block, plan = ops.resolve_plan(kind, TPCH_ROWS, device=dev)
        fn(x, w, Q6_LO, Q6_HI, auto_tile=True)
        form = fn.form
        print(f"[{label}] ring: {form.pieces} piece(s) of {form.piece} rows a "
              f"step, depth {form.depth}, {form.arrays} arrays; shared bytes "
              f"{form.smem_bytes} (plan {plan.vmem_bytes})")
        if (form.block_t, form.depth, form.ring_bytes) != (
                block, plan.depth, plan.vmem_bytes):
            fail(f"{label}: the ring {form} is not the plan's block "
                 f"{block}, depth {plan.depth}, {plan.vmem_bytes} B")
        rows.append(run_folded(
            label, "q6",
            lambda fn=fn: fn(x, w, Q6_LO, Q6_HI, auto_tile=True),
            lambda plain=plain: plain(x, w, Q6_LO, Q6_HI), ref,
            lambda n: q6_reference, host, block, fn, None,
            2 * TPCH_ROWS * 4 + 4, 4 * TPCH_ROWS, f"{CSRC}/filter_fold.cuh",
            f"{HAND}/{src_line}", tier, torch, kernel="filter_fold_kernel",
            one_launch=True, lane_rows=4, piece=form.piece))

        def same(got, want, what):
            limit = SUM_RTOL * abs(float(want))
            if abs(float(got) - float(want)) > limit:
                fail(f"{what}: {float(got)!r} vs plain {float(want)!r} "
                     f"beyond {limit:.4g}")

        aba(label, lambda a, fn=fn: fn(*a, Q6_LO, Q6_HI, auto_tile=True),
            lambda a, plain=plain: plain(*a, Q6_LO, Q6_HI), (x, w),
            (xb, wb), same, torch)
    del x, w, xb, wb

    # ---- keyed sums: 64 keys x 8 values, ~1% of the keys outside
    rng = np.random.RandomState(13)
    keys = rng.randint(0, 64, ROWS).astype(np.int32)
    bad = rng.rand(ROWS) < 0.01
    keys[bad] = rng.choice(np.array([-1, 64], np.int32), int(bad.sum()))
    host = {"keys": keys, "values": rng.randn(ROWS, 8).astype(np.float32)}
    kt, vt = (torch.as_tensor(host[k]).to(dev) for k in ("keys", "values"))
    show_plan("groupby_fold[64x8]", "groupby", ROWS, 64, 8, dev=dev)
    block = ops.resolve_plan("groupby", ROWS, 64, 8, device=dev)[0]
    print(f"[groupby_fold[64x8]] {int(bad.sum())} keys outside [0, 64)")
    form = keyed_form("groupby_fold[64x8]", 64, 8, dev, torch)
    rows.append(run_folded(
        "groupby_fold[64x8]", "gbf",
        lambda: gbf.groupby_fold(kt, vt, 64, auto_tile=True),
        lambda: gbf.groupby_fold_plain(kt, vt, 64),
        keyed_reference(keys, host["values"], 64),
        lambda n: (lambda h: keyed_reference(h["keys"], h["values"], 64)),
        host, block, gbf.groupby_fold, None,
        nbytes_of(kt, vt) + 64 * 8 * 4, ROWS * 8,
        f"{CSRC}/groupby_fold.cuh", f"{HAND}/groupby_fold.py:43", tier, torch,
        kernel=f"{form}_kernel"))
    ran_form("groupby_fold[64x8]", gbf.groupby_fold.form, form)
    del kt, vt

    # ---- MoE router_counts: top-1 expert per token, values one
    keys = np.random.RandomState(14).randint(0, 8, ROWS).astype(np.int32)
    host = {"keys": keys}
    kt = torch.as_tensor(keys).to(dev)
    ones = torch.ones(ROWS, device=dev)
    show_plan("groupby_fold[router]", "groupby", ROWS, 8, 1, dev=dev)
    block = ops.resolve_plan("groupby", ROWS, 8, 1, device=dev)[0]
    form = keyed_form("groupby_fold[router]", 8, 1, dev, torch)
    rows.append(run_folded(
        "groupby_fold[router]", "router",
        lambda: ops.groupby(kt, ones, 8, block_t=block),
        lambda: gbf.groupby_fold_plain(kt, ones, 8),
        np.bincount(keys, minlength=8).astype(np.float64),
        lambda n: (lambda h: np.bincount(h["keys"], minlength=8)
                   .astype(np.float64)),
        host, block, gbf.groupby_fold,
        lambda: torch.zeros(8, device=dev).index_add_(0, kt, ones),
        nbytes_of(kt, ones) + 8 * 4, ROWS, f"{CSRC}/groupby_fold.cuh",
        f"{HAND}/groupby_fold.py:43", tier, torch, kernel=f"{form}_kernel"))
    ran_form("groupby_fold[router]", gbf.groupby_fold.form, form)
    del kt, ones

    # ---- one k-means step, beside the compiler's megakernel
    pipe, make_inputs, reference = kmeans_pipeline(n=ROWS)
    host = make_inputs()
    pts = torch.as_tensor(host["points"]).to(dev)
    cents = torch.as_tensor(host["centroids"]).to(dev)
    show_plan("fused_kmeans", "fused_kmeans", ROWS, 8, 16, dev=dev)
    block, plan = ops.resolve_plan("fused_kmeans", ROWS, 8, 16, device=dev)
    # the rule's CAM form, then the other one, timed beside it
    forms = kmeans_forms()
    for lanes in forms:
        lay = fkm.layout(8, 16, block, plan.depth, lanes)
        label = "fused_kmeans" if lanes == forms[0] \
            else f"fused_kmeans[P={lanes}]"
        print(f"[{label}] sums at P = {lay.lanes} column slot(s), counts at "
              f"P = 1; shared bytes per block {lay.smem_bytes} (ring "
              f"{lay.ring_bytes}, staging {lay.stage_bytes}), depth "
              f"{plan.depth}")
        row = run_folded(
            label, "km_sums",
            lambda lanes=lanes: fkm.fused_kmeans_step(
                pts, cents, auto_tile=True, lanes=lanes),
            lambda: fkm.fused_kmeans_plain(pts, cents), reference(host),
            lambda n: kmeans_pipeline(n=n)[2], host, block,
            fkm.fused_kmeans_step, None,
            nbytes_of(pts, cents) + (8 * 16 + 8) * 4,
            pipeline_ops("kmeans", host), f"{CSRC}/fused_kmeans.cuh",
            f"{HAND}/fused_kmeans.py:61", tier, torch, kernel="kmeans_kernel")
        if fkm.fused_kmeans_step.lanes != lanes:
            fail(f"{label}: ran at P = {fkm.fused_kmeans_step.lanes}")
        if lanes == forms[0]:
            rows.append(row)
    print(f"[fused_kmeans] the rule's P = {forms[0]}: {rows[-1]['ms']:.4f} "
          f"ms; P = {forms[1]}: {row['ms']:.4f} ms", flush=True)
    env = {"points": pts, "centroids": cents}
    gen = cc.fused_dag(kmeans_kernel, env)
    hand = fkm.fused_kmeans_step(pts, cents, auto_tile=True)
    if not torch.equal(hand[1], gen["km_counts"]):
        fail("fused_kmeans: counts differ from the fused_dag[kmeans] kernel")
    hand_ms = median_ms(lambda: fkm.fused_kmeans_step(pts, cents,
                                                      auto_tile=True), torch)
    gen_ms = median_ms(lambda: cc.fused_dag(kmeans_kernel, env), torch)
    print(f"[fused_kmeans] hand-written {hand_ms:.4f} ms vs compiler-"
          f"generated fused_dag[kmeans] {gen_ms:.4f} ms on the same inputs "
          f"(block {kmeans_kernel.spec.block}, depth "
          f"{kmeans_kernel.spec.depth}); counts equal", flush=True)
    return rows


# --------------------------------- the nearest-row DAG at its source shape
KM_CELL = "kmeans.lloyd"     # the benchmark cell whose program and shape
KM_SEED = 3_000_000_019      # the points' and first centroids' seed
KM_CALLS = 3                 # calls of the launch-counting trace
NEAREST_KERNELS = ("nearest_assign_kernel", "nearest_fold_kernel")


def km_check(label: str, out: dict, want: dict, limits: dict, ref) -> dict:
    """Hold one step's ``km_sums`` / ``km_counts`` to the reference's
    admissible intervals (``want``): every count inside its interval
    exactly, the sums within the cell's limit.  Returns the numbers."""
    got = {k: v.cpu().numpy() for k, v in out.items()}
    numbers = ref.errors(got, want)
    if numbers["counts_err"] != 0.0 or \
            numbers["sums_err"] > limits["sums_err"]:
        fail(f"{label}: {numbers} outside the admissible intervals (counts "
             f"exactly, sums within {limits['sums_err']})")
    return numbers


def run_nearest(cc, tier, torch, dev) -> list:
    """Lloyd's k-means at the benchmark cell's shape (faiss's MNIST8m:
    8,099,840 x 784 points, 256 centroids) through ``lower_pipeline`` on
    ``bench/programs/kmeans_lloyd.py``: the nearest-row DAG's assignment
    and fold kernels (``nearest_dag.cuh``) and their two combines.  Two
    Lloyd steps -- centroids drawn from the points, then their means --
    each held, with the plain path (``fused_dag_plain``) on the same
    inputs, to the float64 reference's admissible intervals; the kernel's
    and the plain counts may differ only by the ambiguous points; the
    check must catch the last centroid tile's points moved to the first
    cluster.  Launch counts from the program's counters, reset to 0 just
    before the first call, and from a device trace of KM_CALLS calls;
    the call's and the plain path's ms, each kernel's device ms against
    the bound of its least work (``kernel_work``)."""
    from bench import harness
    from repro_torch.core import pipeline as plmod
    from repro_torch.core import telemetry

    cell = harness.load_cell(KM_CELL, False)
    cfg, limits = cell.config, cell.workload["limits"]
    n, k, d = int(cfg["rows"]), int(cfg["args"]["k"]), int(cfg["args"]["d"])
    ref = harness.module("reference", cfg["program"])
    pipe = harness.module("programs", cfg["program"]).pipeline(
        n, **cfg["args"])
    label = f"nearest[{KM_CELL}]"
    t0 = time.perf_counter()
    call = plmod.lower_pipeline(pipe, device=dev)
    plan = call.pipeline_plan
    print(f"[{label}] n={n} k={k} d={d} plan: block={plan.block} groups="
          f"{list(plan.groups)} depths={list(plan.depths)} onchip_bytes="
          f"{plan.vmem_bytes}; group_lowerings={list(call.group_lowerings)}",
          flush=True)
    if len(call.group_calls) != 1 or any(
            how != "megakernel" for _, how in call.group_lowerings):
        fail(f"{label}: not one group through the megakernel")
    kernel = call.group_calls[0].kernel
    spec = kernel.spec
    if spec.nearest is None:
        fail(f"{label}: the DAG did not take the nearest-row kernels")
    lay = spec.nearest.layout
    kernel.library()
    forms = [(t.name, t.cam_form) for t in spec.terminals]
    print(f"[{label}] layout: tile {lay.tile} ({lay.tiles} tiles), "
          f"{lay.tm} x {lay.tn} a thread, slab {lay.slab}, fold "
          f"{lay.fold_cols} columns ({lay.slices} slices, ring "
          f"{lay.fold_depth}); forms {forms}; shared bytes "
          f"{spec.smem_bytes} / {lay.fold_bytes} (fold); "
          f"lowered and built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    pts = harness.module("data", cfg["data"]["kind"]).make(
        cfg, n, KM_SEED, dev)["points"]
    pick = np.sort(np.random.default_rng(KM_SEED).choice(n, k,
                                                         replace=False))
    cents = pts[torch.as_tensor(pick, device=dev)].clone()
    env = {"points": pts, "centroids": cents}
    torch.cuda.synchronize()
    telemetry.reset()
    telemetry.disable()
    cc.fused_dag.launches = 0
    outs = []
    for step in range(2):
        if step:      # the step's means, as the benchmark's client writes
            new = outs[-1]["km_sums"] / \
                outs[-1]["km_counts"].clamp(min=1.0)[:, None]
            cents.copy_(torch.where(outs[-1]["km_counts"][:, None] > 0, new,
                                    cents))
        out = call(**env)
        again = call(**env)
        torch.cuda.synchronize()
        for name in out:
            if not torch.equal(out[name], again[name]):
                fail(f"{label} step {step}: two calls differ in {name}")
        plain = cc.fused_dag_plain(spec, env)
        want = ref.answer(env)
        e_kernel = km_check(f"{label} step {step}", out, want, limits, ref)
        e_plain = km_check(f"{label} step {step} plain", plain, want,
                           limits, ref)
        moved = float((out["km_counts"] - plain["km_counts"]).abs().sum())
        if moved > 2 * want["ambiguous"] * n:
            fail(f"{label} step {step}: kernel and plain counts differ by "
                 f"{moved:.0f} over {want['ambiguous'] * n:.0f} ambiguous "
                 "points")
        faulted = {key: v.cpu().numpy().copy() for key, v in out.items()}
        last = (lay.tiles - 1) * lay.tile
        faulted["km_counts"][0] += faulted["km_counts"][last:].sum()
        faulted["km_counts"][last:] = 0
        caught = ref.errors(faulted, want)["counts_err"]
        if not caught > limits["counts_err"]:
            fail(f"{label} step {step}: a dropped last tile reads "
                 f"{caught:.3g}, inside the limit {limits['counts_err']}")
        print(f"[{label}] step {step}: kernel {e_kernel}, plain {e_plain} "
              f"(limits {limits}); ambiguous points {want['ambiguous']:.3e}; "
              f"kernel vs plain counts apart by {moved:.0f}; a dropped last "
              f"tile reads counts_err {caught:.3g}; empty clusters "
              f"{int((out['km_counts'] == 0).sum())}", flush=True)
        outs.append(out)
    counters = telemetry.metrics_snapshot()["counters"]
    launches = cc.fused_dag.launches
    # the centroids change in place, so the input signature holds: one
    # eager call captures the graph, the three after it replay it
    want_counts = {"fused_dag.eager_calls": 1, "fused_dag.graph_captures": 1,
                   "fused_dag.graph_replays": 3,
                   "fused_dag.table_tiles": 4 * lay.tiles,
                   "fused_dag.column_slices": 4 * lay.slices}
    seen_counts = {key: counters.get(key, 0) for key in want_counts}
    print(f"[{label}] 4 calls (2 steps, each called twice): fused_dag "
          f"launches {launches}; counters {seen_counts}")
    if launches != 4 or seen_counts != want_counts:
        fail(f"{label}: launches {launches}, counters {seen_counts}; want 4, "
             f"{want_counts}")

    ms = median_ms(lambda: call(**env), torch, reps=5, batch=2)
    plain_ms = median_ms(lambda: cc.fused_dag_plain(spec, env), torch,
                         reps=3, batch=1)
    step_ops = ref.ops({"points": (n, d), "centroids": (k, d)})
    step_bound, _ = bound(4 * (n * d + k * d + k * d + k), step_ops, tier)
    print(f"[{label}] a step {ms:.4f} ms (graph replay), plain {plain_ms:.4f}"
          f" ms, bound {step_bound:.4f} ms ({step_ops} ops)", flush=True)
    seen = device_kernels(lambda: call(**env), torch, KM_CALLS,
                          NEAREST_KERNELS + ("combine_partials",))
    want_launches = {"nearest_assign_kernel": KM_CALLS,
                     "nearest_fold_kernel": KM_CALLS,
                     "combine_partials": 2 * KM_CALLS,
                     "Memcpy DtoD": KM_CALLS}   # a replay's copy of its output
    by = {}
    for name, dms, count in seen:
        key = next((w for w in want_launches if w in name), name)
        by[key] = (dms, count)
    print(f"[{label}] device time per launch over {KM_CALLS} calls: " + (
        ", ".join(f"{name} {dms:.4f} ms x{count}" for name, dms, count in seen)
        or f"not measured (the tracer saw no kernel in {TRACES} traces)"))
    if seen:
        got_launches = {key: by.get(key, (0, 0))[1] for key in want_launches}
        if got_launches != want_launches or len(by) != len(want_launches):
            fail(f"{label}: launches {sorted(by.items())} in the trace; want "
                 f"{want_launches} and nothing else")
    rows = []
    work = ref.kernel_work(n, k, d)
    for name in NEAREST_KERNELS:
        ops_, nbytes = work[name]
        bound_ms, bound_by = bound(nbytes, ops_, tier)
        card = by.get(name, (None, 0))[0]
        print(f"[{label}] {name}: {card if card is None else round(card, 4)}"
              f" ms a launch, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{ops_} ops, {nbytes} B)"
              + (f", {bound_ms / card * 100:.2f}% of it" if card else ""))
        rows.append({
            "name": f"{name}[{KM_CELL}]", "route": "cuda",
            "source": f"{CSRC}/nearest_dag.cuh",
            "replaces": f"{REPLACES}:564", "launches": KM_CALLS,
            "max_abs_err": None, "ms": card, "call_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    del pts, cents, env, outs, out, again, plain
    torch.cuda.empty_cache()
    telemetry.reset()      # tracing as the environment says, for what follows
    return rows


# ------------------------------------------------ LM kernels (attention, SSD)
LM_REPS, LM_BATCH = 5, 2     # the LM phases' calls take up to ~0.1 s each
FA_TPU = f"{HAND}/flash_attention.py:77"
SSD_TPU = f"{HAND}/ssd_scan.py:71"


def lm_randn(shape, seed: int, torch, dev):
    """Standard normal float32 values made on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def fmt_atol(atol) -> str:
    if isinstance(atol, float):
        return f"{atol:.4g}"
    return f"{float(atol.min()):.4g}..{float(atol.max()):.4g} (per row)"


def check_close(got, want, tol: float, atol, torch, what: str):
    """Max abs error of ``got`` against ``want``; fails where
    |got - want| > tol * |want| + atol (a float, or a tensor that
    broadcasts against ``want``), or on a wrong shape or a value that is
    not finite."""
    g, w = got.double(), want.double()
    if tuple(g.shape) != tuple(w.shape) or not bool(torch.isfinite(g).all()):
        fail(f"{what}: not finite of shape {tuple(w.shape)}")
    err = (g - w).abs()
    over = err - (tol * w.abs() + atol)
    if bool((over > 0).any()):
        fail(f"{what}: max abs err {float(err.max()):.4g} exceeds rtol {tol}"
             f" / atol {fmt_atol(atol)} by {float(over.max()):.4g}")
    return float(err.max())


def catches(faulted, want, tol: float, atol) -> bool:
    """Whether the limit of ``check_close`` would fail ``faulted``."""
    shift = (faulted.double() - want).abs()
    return bool((shift > tol * want.abs() + atol).any())


def rounding_fault(want, tol: float, atol, torch, what: str) -> float:
    """The planted fault of a float32 phase: the oracle's output rounded
    to bfloat16, as a kernel that kept its output or state in bfloat16
    would give.  Fails unless the limit catches it; returns its shift."""
    rounded = want.to(torch.bfloat16).double()
    if not catches(rounded, want, tol, atol):
        fail(f"{what}: rtol {tol} / atol {fmt_atol(atol)} would not catch "
             f"the output rounded to bfloat16")
    return float((rounded - want).abs().max())


def attention_f64(q, k, v, causal: bool, window, torch):
    """``ref.attention`` in float64, one (batch, kv head) at a time so the
    logits fit (every row of these phases sees a key, where the oracle's
    -inf mask and the kernel's -1e30 agree)."""
    from repro_torch.kernels import ref

    b, hq = q.shape[:2]
    hkv = k.shape[1]
    group = hq // hkv
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for bi in range(b):
        for h in range(hkv):
            heads = slice(h * group, (h + 1) * group)
            out[bi:bi + 1, heads] = ref.attention(
                q[bi:bi + 1, heads].double(), k[bi:bi + 1, h:h + 1].double(),
                v[bi:bi + 1, h:h + 1].double(), causal=causal, window=window)
    return out


def dropped_block_fault(q, k, v, want, causal, window, q0: int, rows: int,
                        block_k: int, tol: float, atol, torch):
    """The planted fault: the query tile of rows q0.. of (batch 0, head 0)
    loses the kv block that holds most of its softmax mass, as a kernel
    that skipped it would give (float64, the kernel's finite mask: a row
    left with no visible key is the mean of the V it kept).  ``atol`` is
    the per-row limit of those rows.  Returns (the block, the largest
    shift, whether the limit catches it)."""
    from repro_torch.kernels.flash_attention import NEG_INF, visible_mask

    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    qr = q[0, 0, q0:q0 + rows].double()
    kk, vv = k[0, 0].double(), v[0, 0].double()
    logits = (qr @ kk.T) * d ** -0.5
    mask = visible_mask(sq, sk, q0, 0, rows, sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, NEG_INF)
    mass = torch.softmax(logits, -1).sum(0).reshape(-1, block_k).sum(1)
    j = int(mass.argmax())
    keep = torch.ones(sk, dtype=torch.bool, device=q.device)
    keep[j * block_k:(j + 1) * block_k] = False
    faulted = torch.softmax(logits[:, keep], -1) @ vv[keep]
    ref_rows = want[0, 0, q0:q0 + rows]
    shift = float((faulted - ref_rows).abs().max())
    return j, shift, catches(faulted, ref_rows, tol, atol)


def dropped_split_fault(q, k, v, want, causal, window, tile_q: int,
                        splits: int, tol: float, atol, torch):
    """The planted fault of a split launch: the combine loses the partial
    of one split (the one holding the most softmax mass) of the first
    tile of packed rows of (batch 0, kv head 0), as a combine that
    skipped it would give (float64, over the keys the other splits
    cover).  Returns (the split, the largest shift, whether the limit
    catches it)."""
    from repro_torch.kernels.flash_attention import (BC, NEG_INF, _visible,
                                                     live_chunks)

    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    rows = min(tile_q, hq // hkv * sq)
    heads = torch.arange(rows, device=q.device) // sq
    pos = torch.arange(rows, device=q.device) % sq
    qr = q[0, heads, pos].double()
    kk, vv = k[0, 0].double(), v[0, 0].double()
    logits = (qr @ kk.T) * d ** -0.5
    mask = _visible(pos + sk - sq, torch.arange(sk, device=q.device),
                    causal, window)
    logits = logits.masked_fill(~mask, NEG_INF)
    mass = torch.softmax(logits, -1).sum(0)
    spans = [live_chunks(0, rows, sq, sk, causal, window, s, splits)
             for s in range(splits)]
    weight = [float(mass[f * BC:(f + c) * BC].sum()) for f, c in spans]
    split = max(range(splits), key=weight.__getitem__)
    first, count = spans[split]
    keep = torch.ones(sk, dtype=torch.bool, device=q.device)
    keep[first * BC:(first + count) * BC] = False
    faulted = torch.softmax(logits[:, keep], -1) @ vv[keep]
    ref_rows = want[0, heads, pos]
    shift = float((faulted - ref_rows).abs().max())
    return split, shift, catches(faulted, ref_rows, tol,
                                 atol[0, heads, pos])


def sdpa_call(q, k, v, causal: bool, window, torch):
    """One PyTorch call computing the same attention:
    ``scaled_dot_product_attention`` with ``enable_gqa``.  Its
    ``is_causal`` is aligned top left, so it is used only where sq == sk;
    decode (sq 1, every key visible) takes no mask, a window a boolean
    one."""
    from repro_torch.kernels.flash_attention import visible_mask

    sq, sk = q.shape[2], k.shape[2]
    kw = {"enable_gqa": True}
    if window is not None:
        kw["attn_mask"] = visible_mask(sq, sk, 0, 0, sq, sk, causal, window,
                                       q.device)
    elif causal and sq == sk:
        kw["is_causal"] = True
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, **kw)


def sdpa_backend(breakdown: str) -> str:
    low = breakdown.lower()
    for key, name in (("flash", "flash"), ("cudnn", "cudnn"),
                      ("fmha", "memory-efficient"),
                      ("efficient", "memory-efficient")):
        if key in low:
            return name
    return "math (or not measured)"


def run_attention(label: str, cfg, b: int, sq: int, sk: int, dtype, *,
                  causal: bool, window, blocks, seed: int, tier, torch,
                  dev) -> dict:
    """``flash_attention`` at one model's attention widths through its entry
    point: ``blocks`` (block_q, block_k), or the DSE's plan when None.
    Held against its plain version and the float64 oracle (atol per
    output row) after proving the limit catches a kv block dropped from
    the first and from the last q tile and, in float32, an output rounded
    to bfloat16; timed beside its plain version and SDPA."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import visible_mask

    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = lm_randn((b, hq, sq, d), seed, torch, dev).to(dtype)
    k = lm_randn((b, hkv, sk, d), seed + 1, torch, dev).to(dtype)
    v = lm_randn((b, hkv, sk, d), seed + 2, torch, dev).to(dtype)
    kw = {"causal": causal, "window": window}
    shape = (sq, sk, d, hq // hkv, str(dtype)[6:])
    which = fa.variant(q.dtype, k.dtype, v.dtype, d)
    if blocks is None:
        show_plan(label, "attention", *shape, dev=dev)
        (block_q, block_k), plan = ops.resolve_plan("attention", *shape,
                                                    device=dev)
        own = fa.kernel_smem_bytes(which, block_q, d)
        print(f"[{label}] the plan charges {plan.vmem_bytes} B at a tile of "
              f"{block_q} packed rows over {block_k}-key chunks; the "
              f"{which} kernel allocates {own} B there", flush=True)
        if plan.vmem_bytes != own:
            fail(f"{label}: the plan charges {plan.vmem_bytes} B, the "
                 f"kernel allocates {own} B")

        def run():
            return fa.flash_attention(q, k, v, auto_tile=True, **kw)
    else:
        block_q, block_k = blocks
        try:
            show_plan(label, "attention", *shape, dev=dev)
        except ValueError as e:
            print(f"[{label}] DSE: {e}; fixed blocks {blocks}")

        def run():
            return fa.flash_attention(q, k, v, block_q=block_q,
                                      block_k=block_k, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else RTOL
    if dtype == torch.bfloat16 and which != "wgmma":
        fail(f"{label}: bfloat16 attention at head dim {d} would not run "
             "the wgmma kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_q, tiles, splits = fa.launch_plan(
        b, hkv, hq // hkv, sq, sk, which, sms,
        block_q if blocks is None else None)
    torch.cuda.synchronize()
    counters = ("launches", "wgmma_launches", "ffma_launches",
                "combine_launches")
    for name in counters:
        setattr(fa.flash_attention, name, 0)
    out = run()
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    ran = {name: getattr(fa.flash_attention, name) for name in counters}
    print(f"[{label}] {cfg.name}: q {tuple(q.shape)}, k/v {tuple(k.shape)} "
          f"{dtype}, causal={causal}, window={window}, blocks ({block_q}, "
          f"{block_k}); the {which} kernel, {tiles} tiles of {tile_q} packed "
          f"rows per kv head, keys in {splits} split(s); launches: " + ", "
          .join(f"{name} {n}" for name, n in ran.items()))
    if launches < 1:
        fail(f"{label}: the flash_attention kernel was not launched")
    if ran[f"{which}_launches"] != launches:
        fail(f"{label}: expected every launch to run the {which} kernel")
    if (ran["combine_launches"] > 0) != (splits > 1):
        fail(f"{label}: {splits} split(s) but {ran['combine_launches']} "
             "combine launches")

    def plain():
        return fa.flash_attention_plain(q, k, v, block_k=block_k, **kw)
    want = attention_f64(q, k, v, causal, window, torch)
    # atol per output row: tol x the row's root mean square over the head
    # dim.  A row averaging n keys is about sqrt(e / n) in size, so late
    # rows are held as tightly, for their size, as the O(1) first rows.
    atol = tol * want.pow(2).mean(-1, keepdim=True).sqrt()
    rows = min(block_q, sq)
    faults = []
    for q0 in sorted({0, sq - rows}):          # the first and last q tile
        j, shift, caught = dropped_block_fault(
            q, k, v, want, causal, window, q0, rows, block_k, tol,
            atol[0, 0, q0:q0 + rows], torch)
        if not caught:
            fail(f"{label}: rtol {tol} / atol {fmt_atol(atol)} would not "
                 f"catch kv block {j} dropped from the q tile at row {q0} "
                 f"(shift {shift:.4g})")
        faults.append(f"kv block {j} dropped from the q tile at row {q0} "
                      f"shifts it by {shift:.4g}")
    if splits > 1:
        split, shift, caught = dropped_split_fault(
            q, k, v, want, causal, window, tile_q, splits, tol, atol, torch)
        if not caught:
            fail(f"{label}: rtol {tol} / atol {fmt_atol(atol)} would not "
                 f"catch split {split} of {splits} dropped from the combine "
                 f"(shift {shift:.4g})")
        faults.append(f"split {split} of {splits} dropped from the combine "
                      f"shifts the first tile by {shift:.4g}")
    if dtype == torch.float32:
        faults.append("the output rounded to bfloat16 by " + format(
            rounding_fault(want, tol, atol, torch, label), ".4g"))
    p_out = plain()
    e_plain = check_close(out, p_out, tol, atol, torch, f"{label} vs plain")
    e_ref = check_close(out, want, tol, atol, torch, f"{label} vs float64")
    e_pref = check_close(p_out, want, tol, atol, torch,
                         f"{label}: plain vs float64")
    del p_out
    lib = sdpa_call(q, k, v, causal, window, torch)
    e_lib = check_close(lib(), want, tol, atol, torch, f"{label}: SDPA")
    del want
    print(f"[{label}] max abs err vs plain {e_plain:.4g}, vs float64 "
          f"{e_ref:.4g} (plain {e_pref:.4g}, SDPA {e_lib:.4g}); rtol {tol}, "
          f"atol {fmt_atol(atol)}; planted faults caught: "
          + "; ".join(faults))
    del atol
    ms = median_ms(run, torch, LM_REPS, LM_BATCH)
    plain_ms = median_ms(plain, torch, LM_REPS, LM_BATCH)
    lib_ms = median_ms(lib, torch, LM_REPS, LM_BATCH)
    pairs = int(visible_mask(sq, sk, 0, 0, sq, sk, causal, window, dev).sum())
    flops = 4 * b * hq * pairs * d
    peak = BF16_PEAK if dtype == torch.bfloat16 else None
    bound_ms, by = bound(nbytes_of(q, k, v, out), flops, tier, peak)
    lib_parts = device_breakdown(lib, torch)
    print(f"[{label}] flash_attention {ms:.4f} ms ({flops / ms / 1e9:.2f} "
          f"TFLOP/s on visible pairs), plain {plain_ms:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms ({sdpa_backend(lib_parts)} backend), bound "
          f"{bound_ms:.4f} ms ({by}; {pairs} visible pairs per head)",
          flush=True)
    print(f"[{label}] device time per call: " + device_breakdown(run, torch))
    print(f"[{label}] SDPA device time per call: {lib_parts}")
    return {"name": f"flash_attention[{label[10:-1]}]", "route": "cuda",
            "source": f"{CSRC}/flash_attention.cuh", "replaces": FA_TPU,
            "launches": launches, "max_abs_err": e_plain, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms}


SSD_KERNELS = {"scores": "scores_kernel", "states": "states_kernel",
               "carry": "carry_kernel", "output": "output_kernel"}


def ssd_faults(x, dt, A, B, C, want, chunk: int, tol: float, atol,
               torch, label: str) -> str:
    """The SSD's planted faults, each computed in float64 on a slice of
    the inputs and first shown to be caught by the limit: the state carry
    zeroed at the middle chunk boundary (batch 0, head 0: the oracle run
    from there); chunk c's state S_c dropped from the carry (batch 0, head
    0); batch row 1 scored with batch row 0's C Bᵀ over chunk c (rows 0
    and 1, head 0) -- the fault that sharing the scores across heads makes
    possible.  Returns the shifts."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    seq = x.shape[1]
    nc = seq // chunk
    c = nc // 2
    t0 = c * chunk
    out = []

    def check(what, faulted, rows):
        shift = float((faulted - rows).abs().max())
        if not catches(faulted, rows, tol, atol):
            fail(f"{label}: rtol {tol} / atol {atol:.4g} would not catch "
                 f"{what} (shift {shift:.4g})")
        out.append(f"{what} shifts it by {shift:.4g}")
    part = (x[:1, t0:t0 + chunk, :1], dt[:1, t0:t0 + chunk, :1], A[:1],
            B[:1, t0:t0 + chunk], C[:1, t0:t0 + chunk])
    check(f"the carry zeroed at step {t0}",
          ref.ssd_scan(*(t.double() for t in part)),
          want[:1, t0:t0 + chunk, :1])
    xd, dtd, Ad, Bd, Cd = (t.double() for t in (
        x[:2, :, :1], dt[:2, :, :1], A[:1], B[:2], C[:2]))
    scores = ssd.plain_scores(Bd, Cd, chunk)
    S, decay = ssd.plain_states(xd, dtd, Ad, Bd, chunk)
    S[:1, :, c] = 0.0
    y = ssd.plain_output(xd, dtd, Ad, Cd, scores, ssd.plain_carry(S, decay),
                         chunk)
    check(f"chunk {c}'s state dropped from the carry", y[:1],
          want[:1, :, :1])
    S, decay = ssd.plain_states(xd, dtd, Ad, Bd, chunk)
    scores[1, c] = scores[0, c]
    y = ssd.plain_output(xd, dtd, Ad, Cd, scores, ssd.plain_carry(S, decay),
                         chunk)
    check(f"batch row 1 scored with row 0's C Bᵀ over chunk {c}", y[1:2],
          want[1:2, :, :1])
    return "; ".join(out)


def bf16_ulps(got, want32, torch) -> tuple:
    """``got`` (bfloat16) against ``want32`` (float32) rounded to
    bfloat16: the share of elements that differ and the largest
    difference in units of the rounded value's last place."""
    r = want32.to(torch.bfloat16)
    diff = (got.float() - r.float()).abs()
    _, e = torch.frexp(r.float())
    ulp = torch.ldexp(torch.ones_like(diff), (e - 8).clamp(min=-133))
    return (float((got != r).double().mean()),
            float((diff / ulp).max()))


def run_ssd(label: str, cfg, b: int, seq: int, chunk, dtype, seed: int,
            tier, torch, dev) -> dict:
    """``ssd_scan`` at one model's SSD widths through its entry point:
    its four passes each launched once, held against its plain version
    and the float64 recurrence (atol scaled by the output's root mean
    square) after proving the limit catches the planted faults
    (``ssd_faults``; in float32 also the output rounded to bfloat16);
    in bfloat16, held against the float32 kernel on the widened inputs
    within 1 bf16 ulp; two calls bitwise equal; device time per pass;
    timed beside its plain version (no single PyTorch call computes the
    scan).  ``chunk`` None takes the DSE's plan (``auto_tile=True``),
    whose charge is held to the library's own ``ssd_scan_smem``."""
    import ctypes

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    h, dh, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    if h * dh != cfg.d_inner:
        fail(f"{label}: heads x head dim {h * dh} != d_inner {cfg.d_inner}")
    F = torch.nn.functional
    x = lm_randn((b, seq, h, dh), seed, torch, dev).to(dtype)
    dt = (F.softplus(lm_randn((b, seq, h), seed + 1, torch, dev))
          * 0.1).to(dtype)
    A = -F.softplus(lm_randn((h,), seed + 2, torch, dev)) - 0.1
    B = lm_randn((b, seq, n), seed + 3, torch, dev).to(dtype)
    C = lm_randn((b, seq, n), seed + 4, torch, dev).to(dtype)
    auto = chunk is None
    if auto:
        show_plan(label, "scan", seq, n, dh, dev=dev)
        chunk, plan = ops.resolve_plan("scan", seq, n, dh, device=dev)
        own = ctypes.c_int(0)
        ssd.LIB("ssd_scan_smem", chunk, ctypes.byref(own))
        print(f"[{label}] the plan charges {plan.vmem_bytes} B at chunk "
              f"{chunk}; the kernel allocates {own.value} B there",
              flush=True)
        if plan.vmem_bytes != own.value:
            fail(f"{label}: the plan charges {plan.vmem_bytes} B, the "
                 f"kernel allocates {own.value} B")
    else:
        try:
            show_plan(label, "scan", seq, n, dh, dev=dev)
        except ValueError as e:
            print(f"[{label}] DSE: {e}; fixed chunk {chunk}")
    tol = BF16_TOL if dtype == torch.bfloat16 else SSD_F32_TOL

    def run():
        if auto:
            return ssd.ssd_scan(x, dt, A, B, C, auto_tile=True)
        return ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)

    def plain():
        return ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    ssd.ssd_scan.launches = 0
    ssd.ssd_scan.pass_launches = dict.fromkeys(ssd.PASSES, 0)
    y = run()
    torch.cuda.synchronize()
    launches = ssd.ssd_scan.launches
    passes = dict(ssd.ssd_scan.pass_launches)
    lay = ssd.layout(chunk)
    ws = ssd.workspace_bytes(b, seq, h, dh, n, chunk)
    print(f"[{label}] {cfg.name}: x {tuple(x.shape)} {dtype}, state ({n}, "
          f"{dh}), chunk {chunk} whole ({len(lay.row_tiles)} row tiles of "
          f"{ssd.TILE}, {len(lay.slabs)} slabs of {ssd.SLAB}, "
          f"{lay.smem_bytes} B of shared memory a block); workspaces "
          + ", ".join(f"{k} {v} B" for k, v in ws.items())
          + f"; ssd_scan calls={launches}, launches: "
          + ", ".join(f"{k} {v}" for k, v in passes.items()))
    if launches < 1 or any(v < 1 for v in passes.values()):
        fail(f"{label}: a pass of the ssd_scan kernel was not launched")
    if not torch.equal(y, run()):
        fail(f"{label}: two calls are not bitwise equal")
    want = ref.ssd_scan(*(t.double() for t in (x, dt, A, B, C)))
    atol = tol * float(want.pow(2).mean().sqrt())
    faults = ssd_faults(x, dt, A, B, C, want, chunk, tol, atol, torch,
                        label)
    if dtype == torch.float32:
        faults += "; the output rounded to bfloat16 by " + format(
            rounding_fault(want, tol, atol, torch, label), ".4g")
    p_y = plain()
    e_plain = check_close(y, p_y, tol, atol, torch, f"{label} vs plain")
    e_ref = check_close(y, want, tol, atol, torch, f"{label} vs float64")
    e_pref = check_close(p_y, want, tol, atol, torch,
                         f"{label}: plain vs float64")
    y_max = float(want.abs().max())
    del want, p_y
    print(f"[{label}] max abs err vs plain {e_plain:.4g}, vs float64 "
          f"{e_ref:.4g} (plain {e_pref:.4g}); rtol {tol}, atol {atol:.4g} "
          f"(max |y| {y_max:.4g}); two calls bitwise equal; planted faults "
          f"caught: {faults}")
    if dtype == torch.bfloat16:
        # rule A: every product is float32 FFMA, so the bf16 kernel is the
        # f32 kernel on the widened inputs, rounded once at the output
        y32 = ssd.ssd_scan(x.float(), dt.float(), A, B.float(), C.float(),
                           chunk=chunk)
        share, worst = bf16_ulps(y, y32, torch)
        print(f"[{label}] vs the float32 kernel on the widened inputs, "
              f"rounded to bfloat16: {share:.6g} of the elements differ, "
              f"by at most {worst:.4g} ulp (limit 1)")
        if worst > 1:
            fail(f"{label}: {worst:.4g} bf16 ulp from the float32 kernel")
        del y32
    ms = median_ms(run, torch, LM_REPS, LM_BATCH)
    plain_ms = median_ms(plain, torch, LM_REPS, LM_BATCH)
    # the least work: per step and state element, one FMA to carry the
    # state and one to read it out, on FFMA in both types: these products
    # have a float32 operand (the state), which rule A keeps off the
    # tensor cores; C Bᵀ, the one product they may take, is not counted
    flops = 4 * b * seq * h * n * dh
    bound_ms, by = bound(nbytes_of(x, dt, A, B, C, y), flops, tier)
    print(f"[{label}] ssd_scan {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"none, bound {bound_ms:.4f} ms ({by})", flush=True)
    breakdown(label, run, list(SSD_KERNELS.values()), torch)
    return {"name": f"ssd_scan[{label[4:-1]}]", "route": "cuda",
            "source": f"{CSRC}/ssd_scan.cuh", "replaces": SSD_TPU,
            "launches": launches, "max_abs_err": e_plain, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None}


def run_lm_kernels(tier, torch, dev) -> list:
    """flash_attention and ssd_scan through their entry points at the
    published widths of granite-3-2b, mixtral-8x22b, qwen2-72b (head dim
    128, the card's own plan) and mamba2-370m (state 128; fixed and
    planned chunks)."""
    from repro_torch.configs import SHAPES, get_config

    granite = get_config("granite-3-2b")
    qwen2 = get_config("qwen2-72b")
    mixtral = get_config("mixtral-8x22b")
    mamba = get_config("mamba2-370m")
    bf16, f32 = torch.bfloat16, torch.float32
    ctx = SHAPES["decode_32k"].seq_len
    rows = []
    for dtype, blocks, tag in ((f32, (128, 128), "f32"),
                               (bf16, (128, 128), "bf16"),
                               (bf16, None, "bf16,auto")):
        rows.append(run_attention(
            f"attention[granite,prefill,{tag}]", granite, 2, 4096, 4096,
            dtype, causal=True, window=None, blocks=blocks, seed=21,
            tier=tier, torch=torch, dev=dev))
    rows.append(run_attention(
        "attention[granite,decode,bf16,auto]", granite, 32, 1, ctx, bf16,
        causal=True, window=None, blocks=None, seed=24, tier=tier,
        torch=torch, dev=dev))
    rows.append(run_attention(
        "attention[mixtral,swa,bf16]", mixtral, 1, 8192, 8192, bf16,
        causal=True, window=mixtral.sliding_window, blocks=(128, 128),
        seed=27, tier=tier, torch=torch, dev=dev))
    rows.append(run_attention(
        "attention[qwen2,prefill,bf16,auto]", qwen2, 2, 4096, 4096, bf16,
        causal=True, window=None, blocks=None, seed=33, tier=tier,
        torch=torch, dev=dev))
    rows.append(run_attention(
        "attention[qwen2,decode,bf16,auto]", qwen2, 32, 1, ctx, bf16,
        causal=True, window=None, blocks=None, seed=36, tier=tier,
        torch=torch, dev=dev))
    for dtype, chunk, tag in ((f32, 128, "f32"), (bf16, 128, "bf16"),
                              (bf16, None, "bf16,auto")):
        rows.append(run_ssd(f"ssd[mamba2,{tag}]", mamba, 4, 4096, chunk,
                            dtype, 30, tier, torch, dev))
    return rows


# ------------------------------------------- paged decode and paged serving
PD_TPU = f"{REPLACES}:893"
PD_SRC = f"{CSRC}/paged_decode.cuh"
PD_CTX = 8192                # the kernel phase: context bound per request
PD_BATCH = 32
PD_TOL = SSD_F32_TOL         # float32 output from the same bf16 K and V
SERVE_SLOTS, SERVE_GEN, SERVE_REQUESTS = 8, 64, 16
SERVE_PROMPTS = (64, 960)    # seeded prompt lengths; one is 960
PD_LIBRARY = "none: no one PyTorch call appends and attends over a page table"


def pd_inputs(cfg, lens, ps: int, npm: int, layout: str, seed: int, torch,
              dev):
    """One paged-decode step at ``cfg``'s attention widths: bf16 q, new K
    and V and pools made on the card from ``seed``, a page table of
    shuffled, disjoint page ids (page 0 reserved), lengths ``lens``."""
    b = len(lens)
    hkv, group, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    n_phys = 1 + b * npm
    heads = 2 * hkv if layout == "fused" else hkv
    pools = tuple(torch.randn((n_phys, ps, heads, dh), generator=gen,
                              device=dev, dtype=bf16)
                  for _ in range(1 if layout == "fused" else 2))
    table = (1 + torch.randperm(n_phys - 1, generator=gen, device=dev)
             ).to(torch.int32).reshape(b, npm)
    q = torch.randn((b, hkv, group, dh), generator=gen, device=dev,
                    dtype=bf16)
    k, v = (torch.randn((b, hkv, dh), generator=gen, device=dev, dtype=bf16)
            for _ in range(2))
    lens = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    return q, k, v, pools, table, lens


def pd_oracle(q, pools, table, lens, layout: str, torch, drop=None,
              p_type=None):
    """Float64 gather-and-softmax oracle of one paged-decode step over
    ``pools`` (after the append): request b attends over positions
    0..lens[b] through its page table.  Planted faults: ``drop(b)``,
    when given, is a range of positions request b loses (or None);
    ``p_type``, when given, is the type p is rounded to before PV."""
    b, hkv, group, dh = q.shape
    ps = pools[0].shape[1]
    kpool, vpool = pools[0], pools[-1]
    kh = torch.arange(hkv, device=q.device) * (2 if layout == "fused" else 1)
    vh = kh + (1 if layout == "fused" else 0)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for r in range(b):
        pos = torch.arange(int(lens[r]) + 1, device=q.device)
        lost = drop(r) if drop is not None else None
        if lost is not None:
            pos = pos[(pos < lost[0]) | (pos >= lost[1])]
        pages, slots = table[r, pos // ps].long(), pos % ps
        kk = kpool[pages, slots][:, kh].double().transpose(0, 1)  # (H, n, D)
        vv = vpool[pages, slots][:, vh].double().transpose(0, 1)
        s = q[r].double() @ kk.transpose(-1, -2) * dh ** -0.5
        p = torch.softmax(s, -1)
        if p_type is not None:
            p = p.to(p_type).double()
        out[r] = p @ vv
    return out


def run_paged(label: str, cfg, lens, ps: int, npm: int, layout: str,
              seed: int, tier, torch, dev) -> dict:
    """``lower_paged_decode`` at ``cfg``'s widths: pools bitwise against
    ``paged_decode_plain``; the float32 output against the plain version
    and the float64 oracle at rtol PD_TOL and a per-row atol of PD_TOL x
    the oracle row's root mean square, after proving that limit catches
    the longest request's last live page dropped, the append skipped, p
    rounded to bfloat16 before PV, the output rounded to bfloat16 and,
    where the context is split across blocks, one split's partial
    dropped in the combine; one attend launch and, with splits, one
    combine; timed beside the plain version, with the byte bound of the
    live pages, q, the new K/V and the output."""
    from repro_torch.core import codegen_cuda as cc

    q, k, v, pools, table, lens_t = pd_inputs(cfg, lens, ps, npm, layout,
                                              seed, torch, dev)
    b, hkv, group, dh = q.shape
    before_pools = tuple(p.clone() for p in pools)
    plain_pools = tuple(p.clone() for p in pools)
    kern = cc.lower_paged_decode(batch=b, kv_heads=hkv, group=group,
                                 head_dim=dh, page_size=ps, n_pages_max=npm,
                                 layout=layout)
    splits = cc.paged_splits(b, hkv, npm, ps, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    torch.cuda.synchronize()
    counts = pd_counts(cc, reset=True)
    out, _ = kern(q, k, v, pools, table, lens_t)
    torch.cuda.synchronize()
    launches, attend, combine = counts = pd_counts(cc)
    live = [-(-(int(n) + 1) // ps) for n in lens]
    print(f"[{label}] {cfg.name}: {b} requests x {hkv} kv heads x group "
          f"{group} x head dim {dh}, {layout} bf16 pools of page size {ps}, "
          f"{npm} pages per request, seq_len {min(lens)}..{max(lens)} "
          f"({sum(live)} live pages); {splits} splits, {hkv * b * splits} "
          f"attend blocks; lower_paged_decode launches={launches} (attend "
          f"{attend}, combine {combine})")
    if counts != (1, 1, int(splits > 1)):
        fail(f"{label}: expected one call, one attend launch and "
             f"{int(splits > 1)} combine launches, got {counts}")

    def plain():
        return cc.paged_decode_plain(q, k, v, plain_pools, table, lens_t,
                                     layout=layout)
    p_out = plain()
    for i, (got, want_pool) in enumerate(zip(pools, plain_pools)):
        if not torch.equal(got, want_pool):
            fail(f"{label}: pool {i} differs from the plain version's")
    want = pd_oracle(q, pools, table, lens_t, layout, torch)
    atol = PD_TOL * want.pow(2).mean(-1, keepdim=True).sqrt()
    longest = int(np.argmax(lens))
    n_top = int(lens[longest]) + 1
    last = (-(-n_top // ps) - 1) * ps
    dropped = pd_oracle(q, pools, table, lens_t, layout, torch,
                        drop=lambda r: (last, n_top) if r == longest
                        else None)
    stale = pd_oracle(q, before_pools, table, lens_t, layout, torch)
    p_bf16 = pd_oracle(q, pools, table, lens_t, layout, torch,
                       p_type=torch.bfloat16)
    planted = [(f"request {longest}'s last live page dropped", dropped),
               ("the append skipped", stale),
               ("p rounded to bfloat16 before PV", p_bf16)]
    if splits > 1:
        # the combine loses the middle part of the longest request
        ppc = cc.PD_KC // ps
        ck = ppc * ps
        n_chunks = -(-(-(-n_top // ps)) // ppc)     # live pages in chunks
        first, end = cc.pd_split_range(n_chunks, splits // 2, splits)
        planted.append((
            f"split {splits // 2} of {splits} (keys {first * ck}.."
            f"{min(end * ck, n_top) - 1}) of request {longest} dropped in "
            "the combine",
            pd_oracle(q, pools, table, lens_t, layout, torch,
                      drop=lambda r: (first * ck, end * ck) if r == longest
                      else None)))
    faults = []
    for what, faulted in planted:
        shift = float((faulted - want).abs().max())
        if not catches(faulted, want, PD_TOL, atol):
            fail(f"{label}: rtol {PD_TOL} / atol {fmt_atol(atol)} would not "
                 f"catch {what} (shift {shift:.4g})")
        faults.append(f"{what} shifts it by {shift:.4g}")
    faults.append("the output rounded to bfloat16 shifts it by "
                  f"{rounding_fault(want, PD_TOL, atol, torch, label):.4g}")
    del dropped, stale, p_bf16, before_pools, planted
    e_plain = check_close(out, p_out, PD_TOL, atol, torch, f"{label} vs plain")
    e_ref = check_close(out, want, PD_TOL, atol, torch, f"{label} vs float64")
    e_pref = check_close(p_out, want, PD_TOL, atol, torch,
                         f"{label}: plain vs float64")
    print(f"[{label}] pools bitwise equal to plain; max abs err vs plain "
          f"{e_plain:.4g}, vs float64 {e_ref:.4g} (plain {e_pref:.4g}); rtol "
          f"{PD_TOL}, atol {fmt_atol(atol)}; planted faults caught: "
          + "; ".join(faults))
    del want, atol, p_out

    def run():
        return kern(q, k, v, pools, table, lens_t)
    ms = median_ms(run, torch)
    plain_ms = median_ms(plain, torch, LM_REPS, LM_BATCH)
    kv_bytes = 2 * sum(live) * ps * hkv * dh * pools[0].element_size()
    nbytes = kv_bytes + nbytes_of(q, k, v, out)
    keys = sum(int(n) + 1 for n in lens)
    flops = 4 * keys * hkv * group * dh
    bound_ms, by = bound(nbytes, flops, tier)
    print(f"[{label}] paged_decode {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s"
          f" of live pages and operands), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}: {nbytes} B; ratio {ms / bound_ms:.2f});"
          f" library {PD_LIBRARY}", flush=True)
    print(f"[{label}] device time per call: " + device_breakdown(run, torch))
    return {"name": f"paged_decode[{label[13:-1]}]", "route": "cuda",
            "source": PD_SRC, "replaces": PD_TPU, "launches": launches,
            "max_abs_err": e_plain, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


def pd_counts(cc, reset: bool = False) -> tuple:
    """``lower_paged_decode``'s counts: (calls, attend kernel launches,
    combine kernel launches), set to 0 first when ``reset``."""
    f = cc.lower_paged_decode
    if reset:
        f.launches = f.attend_launches = f.combine_launches = 0
    return f.launches, f.attend_launches, f.combine_launches


def paged_lens(ps: int, rng) -> list:
    """PD_BATCH seeded lengths in [1, PD_CTX - 1] with page-boundary
    values: the table's last slot, a page's last and first slots."""
    lens = rng.randint(1, PD_CTX, PD_BATCH)
    lens[:5] = [PD_CTX - 1, ps - 1, ps, 37 * ps - 1, 37 * ps]
    return [int(n) for n in rng.permutation(np.minimum(lens, PD_CTX - 1))]


def run_paged_kernels(tier, torch, dev) -> list:
    """lower_paged_decode at granite-3-2b's widths: page sizes 8 (the
    card's plan) and 64, both layouts, 32 requests of up to 8192 tokens."""
    from repro_torch.configs import get_config

    granite = get_config("granite-3-2b")
    rows = []
    for ps in (8, 64):
        lens = paged_lens(ps, np.random.RandomState(40 + ps))
        for layout in ("split", "fused"):
            rows.append(run_paged(
                f"paged_decode[granite,{layout},p{ps}]", granite, lens, ps,
                PD_CTX // ps, layout, 41, tier, torch, dev))
    return rows


def forced_oracle(cfg, params, prompt, toks, cmax: int, torch, dev):
    """The dense ``decode_step`` oracle's logits for each token the
    server returned for one request, teacher-forced: the prompt's greedy
    token as the server prefills it (one block into a cache of the
    prompt's length), then one block over the prompt, that token and the
    server's tokens but the last, from position 0, into a no-wrap cache
    of the page-padded extent.  Row t scores the server's token t (pad
    vocab masked).  A MoE layer routes a token with the others of its
    block (capacity is per routing group), so for MoE the prompt's
    prefilled cache is kept as the server keeps it and the served tokens
    follow in blocks of SERVE_SLOTS, the size of a served step's group
    (at top-1 no choice of such a group is dropped, as in the server's
    steps).  A token whose k-th and (k+1)-th router logits lie within
    the model type's tolerance is a routing tie, which two summation
    orders break either way as they break a tie of the greedy token: its
    row of ``alt`` holds the logits with that choice taken by the
    (k+1)-th expert (the block rerun on a copy of the cache), its other
    rows are ``rows``'.  Returns ``(rows, alt)``, (gen, vocab) float32
    logits each (``alt`` None without MoE)."""
    from repro_torch.launch import serve, steps
    from repro_torch.models import model, moe

    ln = prompt.shape[1]
    dc = model.init_cache(cfg, 1, ln, device=dev)
    first, dc = serve._prefill(steps.make_cache_prefill_step(cfg), params,
                               dc, prompt, ln)
    seq = torch.cat([prompt, first.reshape(1, 1),
                     torch.as_tensor(toks[None, :-1], dtype=torch.int32,
                                     device=dev)], 1)
    cache = model.init_cache(cfg, 1, cmax, device=dev)
    if not cfg.n_experts:
        logits, _ = model.decode_step(params, cfg, cache, seq, 0)
        return model.mask_vocab_pad(logits, cfg)[0, ln:].float(), None
    for name in ("k", "v"):
        cache[name][:, :, :, :ln] = dc[name]
    rtol, atol = serve.TOLERANCES[cfg.dtype]
    real, k = moe.route, cfg.top_k
    rows, alts = [], []
    for i in range(ln, seq.shape[1], SERVE_SLOTS):
        block = seq[:, i:i + SERVE_SLOTS]
        ties = []                           # one mask per MoE layer

        def record(logits, c, cap):
            v = moe.top_k(logits, k + 1)[0]
            ties.append(v[..., k - 1] - v[..., k]
                        <= atol + rtol * v[..., k - 1].abs())
            return real(logits, c, cap)

        def flipped(logits, c, cap):
            tie = ties.pop(0)
            kth = moe.top_k(logits, k)[1][..., k - 1:]
            logits = logits.scatter(-1, kth, torch.where(
                tie[..., None], float("-inf"), logits.gather(-1, kth)))
            return real(logits, c, cap)

        copy = {name: t.clone() for name, t in cache.items()}
        moe.route = record
        try:
            logits, cache = model.decode_step(params, cfg, cache, block, i)
        finally:
            moe.route = real
        row = model.mask_vocab_pad(logits, cfg)[0].float()
        tied = torch.stack(ties).any(0).reshape(-1)
        alt = row
        if bool(tied.any()):
            moe.route = flipped
            try:
                other, _ = model.decode_step(params, cfg, copy, block, i)
            finally:
                moe.route = real
            alt = torch.where(tied[:, None], model.mask_vocab_pad(
                other, cfg)[0].float(), row)
        rows.append(row)
        alts.append(alt)
    return torch.cat(rows), torch.cat(alts)


def serve_call(cfg, lens, params, dev, **kw):
    """Serve ``lens`` over SERVE_SLOTS slots, SERVE_GEN tokens each:
    through ``serve_continuous`` for a published config (in ``cfg``'s
    type), through ``_serve_continuous`` for one whose depth was cut."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    if cfg == get_config(cfg.name).with_(dtype=cfg.dtype):
        return serve.serve_continuous(
            cfg.name, False, SERVE_SLOTS, SERVE_GEN, prompt_lens=lens,
            params=params, device=dev, dtype=cfg.dtype, **kw)
    return serve._serve_continuous(cfg, SERVE_SLOTS, SERVE_GEN,
                                   prompt_lens=lens, params=params,
                                   device=dev, **kw)


def make_params(what: str, cfg, torch, dev):
    """``model.init_params(cfg, 0)`` on the card, with its count, bytes,
    time and the card's peak memory while they were made."""
    from repro_torch.models import model

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in params.values())
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    print(f"[{what}] {n} random {cfg.dtype} weights ({nbytes / 1e9:.2f} GB) "
          f"made on the card in {time.perf_counter() - t0:.2f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} "
          "GB", flush=True)
    return params


def serve_once(cfg, lens, params, torch, dev, what: str):
    """``serve_call`` of ``cfg`` with the kernel, certified first, its
    launch count reset just before and read just after; fails unless it
    launched once per layer and step (plus the certification's), admitted
    and evicted every request and modeled fewer words than a dense cache.
    Returns (tokens, stats, launches)."""
    from repro_torch.core import codegen_cuda as cc

    pd_counts(cc, reset=True)
    toks, stats = serve_call(cfg, lens, params, dev, use_kernel=True,
                             certify=True)
    torch.cuda.synchronize()
    launches, attend, combine = pd_counts(cc)
    cert = cfg.n_layers * (5 + 4 - 1)        # _certify_paged_decode's steps
    print(f"[{what}] prefill {stats['prefill_s']:.3f} s, decode "
          f"{stats['decode_s']:.3f} s over {stats['steps']} steps "
          f"({stats['ms_per_token']:.3f} ms per token, "
          f"{stats['decode_s'] / stats['steps'] * 1e3:.3f} ms per step), "
          f"occupancy {stats['occupancy']:.4f}; lower_paged_decode launches="
          f"{launches} ({cfg.n_layers} x {stats['steps']} steps + {cert} "
          f"certifying; attend {attend}, combine {combine})")
    if launches != cfg.n_layers * stats["steps"] + cert:
        fail(f"{what}: {launches} kernel launches, expected "
             f"{cfg.n_layers * stats['steps'] + cert}")
    if attend != launches or not combine:
        fail(f"{what}: every call must launch the attend kernel and the "
             f"serving shape the combine (attend {attend}, combine "
             f"{combine} in {launches} calls)")
    if not stats["certified"] or not stats["use_pallas"]:
        fail(f"{what}: the fused kernel was not certified and used")
    if stats["admitted"] != SERVE_REQUESTS or \
            stats["evicted"] != SERVE_REQUESTS:
        fail(f"{what}: admitted {stats['admitted']}, evicted "
             f"{stats['evicted']} of {SERVE_REQUESTS}")
    if not 0 < stats["modeled_paged_traffic_words"] \
            < stats["modeled_dense_traffic_words"]:
        fail(f"{what}: modeled paged words not below dense words")
    if toks.shape != (SERVE_REQUESTS, SERVE_GEN) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        fail(f"{what}: tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    return toks, stats, launches


def forced_rows(cfg, params, lens, toks, cmax: int, torch, dev) -> list:
    """The teacher-forced dense oracle's logits (``forced_oracle``) for
    every request's served tokens ``toks``."""
    pool = np.random.RandomState(0).randint(0, cfg.vocab,
                                            (SERVE_REQUESTS, max(lens)))
    rows = []
    for r, ln in enumerate(lens):
        prompt = torch.as_tensor(pool[r:r + 1, :ln], dtype=torch.int32,
                                 device=dev)
        rows.append(forced_oracle(cfg, params, prompt, toks[r], cmax, torch,
                                  dev))
    return rows


def torch_equal(a, b) -> bool:
    return bool((a == b).all())


def first_misses(rows, toks, dtype: str) -> list:
    """Per request, the first step whose served token the check refuses,
    or None.  float32: the token must be the oracle's greedy token;
    bfloat16: one the oracle scores within the bf16 tolerance of its
    best (``serve.near_best``), since two summation orders break its
    ties differently; at a routing tie (``forced_oracle``'s ``alt``),
    within that tolerance of the best of either routing's logits.  Also
    returns how many served tokens pass."""
    from repro_torch.launch import serve

    misses, passed = [], 0
    for r, (logits, alt) in enumerate(rows):
        best = logits.argmax(-1).cpu().numpy()
        miss = None
        for t in range(toks.shape[1]):
            tok = int(toks[r, t])
            ok = tok == best[t] if dtype == "float32" else \
                serve.near_best(logits[t], tok, dtype) or (
                    alt is not None and serve.near_best(alt[t], tok, dtype))
            passed += ok
            if not ok and miss is None:
                miss = (t, f"request {r} token {t}: {tok} scores "
                           f"{float(logits[t, tok]):.4g}, the oracle's "
                           f"{int(best[t])} {float(logits[t].max()):.4g}"
                           + ("" if alt is None or torch_equal(alt[t],
                                                               logits[t])
                              else f" (other routing: {tok} scores "
                              f"{float(alt[t, tok]):.4g} of "
                              f"{float(alt[t].max()):.4g})"))
        misses.append(miss)
    return misses, passed


def check_tokens(cfg, params, lens, toks, cmax: int, dtype: str, torch, dev,
                 what: str = ""):
    """Hold the server's tokens against the teacher-forced dense oracle
    (``first_misses``); in bfloat16, first prove the limit rejects
    another request's tokens."""
    from repro_torch.launch import serve

    what = what or f"serving[{dtype}]"
    t0 = time.perf_counter()
    rows = forced_rows(cfg.with_(dtype=dtype), params, lens, toks, cmax,
                       torch, dev)
    same = ties = routing = by_alt = 0
    worst = 0.0
    for r, (logits, alt) in enumerate(rows):
        if alt is not None:
            flip = (alt != logits).any(-1)
            routing += int(flip.sum())
            for t in torch.nonzero(flip).reshape(-1).tolist():
                by_alt += not serve.near_best(logits[t], int(toks[r, t]),
                                              dtype)
        top = torch.topk(logits, 2, dim=-1)
        ties += int((top.values[:, 0] == top.values[:, 1]).sum())
        same += int((top.indices[:, 0].cpu().numpy() == toks[r]).sum())
        served = logits.gather(1, torch.as_tensor(
            toks[r], device=logits.device)[:, None])[:, 0]
        worst = max(worst, float((top.values[:, 0] - served).max()))
    n = SERVE_REQUESTS * SERVE_GEN
    print(f"[{what}] teacher-forced dense oracle ({cmax}-slot cache) in "
          f"{time.perf_counter() - t0:.1f} s: {same} of {n} tokens the "
          f"oracle's greedy token, {ties} steps with a tie at the top, "
          f"largest deficit of a served token's logit {worst:.4g}"
          + ("" if not cfg.n_experts else
             f"; {routing} steps with a routing tie, {by_alt} served tokens "
             "within the tolerance only of the other routing's logits"))
    if dtype != "float32":
        other = np.roll(toks, -1, axis=0)
        caught = sum(m is not None for m in first_misses(rows, other,
                                                         dtype)[0])
        if caught != len(rows):
            fail(f"{what}: the tolerance would not catch another request's "
                 f"tokens in {len(rows) - caught} of {len(rows)} requests")
        print(f"[{what}] planted fault caught: another request's tokens fail"
              f" the tolerance in {caught} of {len(rows)} requests")
    misses = [m for m in first_misses(rows, toks, dtype)[0] if m]
    if misses:
        fail(f"{what}: tokens differ from the dense oracle: "
             + "; ".join(text for _, text in misses))
    print(f"[{what}] all {SERVE_REQUESTS} requests "
          + ("token-identical to" if dtype == "float32" else
             "within the bf16 tolerance of") + " the dense oracle",
          flush=True)


def append_skipped(cc, torch):
    """A planted kernel fault on the serving path: ``paged_decode`` with
    the append skipped (each request's slot rewritten with what it held,
    which the attention then reads in place of the new K and V).
    Returns a function that undoes it."""
    real = cc.paged_decode

    def faulted(q, new_k, new_v, pools, page_table, seq_lens, *, layout):
        ki, vi, _, mul, k_off, v_off = cc._pd_heads(layout, q.shape[1])
        kpool, vpool = pools[ki], pools[vi]
        n_phys, ps = kpool.shape[0], kpool.shape[1]
        rows = torch.arange(q.shape[0], device=q.device)
        lens = seq_lens.long()
        page = page_table.long()[rows, (lens // ps).clamp(
            0, page_table.shape[1] - 1)].clamp(0, n_phys - 1)
        heads = torch.arange(q.shape[1], device=q.device) * mul
        old_k = kpool[page, lens % ps][:, heads + k_off]
        old_v = vpool[page, lens % ps][:, heads + v_off]
        return real(q, old_k, old_v, pools, page_table, seq_lens,
                    layout=layout)

    cc.paged_decode = faulted

    def undo():
        cc.paged_decode = real
    return undo


def faulted_serving(cfg, params, lens, cmax: int, layout: str, ps: int,
                    torch, dev, what: str) -> None:
    """Prove the bfloat16 checks reject a real kernel fault on the
    serving path (``append_skipped``): certification raises, and the
    tokens of an uncertified faulted run fail ``first_misses`` in at
    least one request (it reports how many tokens still pass)."""
    from repro_torch.core import codegen_cuda as cc
    from repro_torch.launch import serve

    undo = append_skipped(cc, torch)
    try:
        try:
            serve._certify_paged_decode(cfg, params, layout=layout,
                                        page_size=ps, device=dev)
        except RuntimeError as e:
            print(f"[{what}] certification raised: {e}")
        else:
            fail(f"{what}: certification passed the faulted kernel")
        toks, _ = serve_call(cfg, lens, params, dev, use_kernel=True,
                             certify=False)
    finally:
        undo()
    rows = forced_rows(cfg, params, lens, toks, cmax, torch, dev)
    misses, passed = first_misses(rows, toks, cfg.dtype)
    caught = sum(m is not None for m in misses)
    print(f"[{what}] the bf16 check rejects {caught} of {len(rows)} "
          f"requests; {passed} of {toks.size} faulted tokens lie within "
          f"the bf16 tolerance of the oracle's best (first misses at steps "
          f"{sorted(m[0] for m in misses if m)})", flush=True)
    if not caught:
        fail(f"{what}: the bf16 tolerance passes every faulted token")


def device_busy(fn, torch, calls: int = 3, want=()) -> tuple:
    """(wall ms per call on the host clock, device-busy ms per call, the
    five costliest CUDA kernels, device ms per call by kernel name) of
    ``fn`` under torch.profiler (``trace``, which looks for ``want``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e3
    kernels = trace(fn, torch, calls, want)
    busy = sum(us for _, us, _ in kernels) / calls / 1e3
    top = sorted(kernels, key=lambda k: k[1], reverse=True)[:5]
    names = ", ".join(f"{key.split('(')[0][:40]} {us / calls / 1e3:.3f}"
                      f" ms x{count // calls}" for key, us, count in top)
    by_name = {key: us / calls / 1e3 for key, us, _ in kernels}
    return wall, busy, names or "not measured", by_name


def serve_lens(seed: int) -> list:
    """SERVE_REQUESTS seeded prompt lengths in SERVE_PROMPTS, one of them
    the longest."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                       SERVE_REQUESTS)
    lens[rng.randint(SERVE_REQUESTS)] = SERVE_PROMPTS[1]
    return [int(n) for n in lens]


def profile_step(label: str, cfg, params, lens, cmax: int, ps: int,
                 layout: str, torch, dev) -> tuple:
    """One decode step at the serving shapes (the first SERVE_SLOTS
    requests halfway through their generation) under torch.profiler:
    prints and returns (host ms, device busy ms, the paged kernels' ms);
    fails if the trace shows no paged kernel."""
    from repro_torch.models import paged

    mid = [lens[i % len(lens)] + SERVE_GEN // 2 for i in range(SERVE_SLOTS)]
    cache = paged.PagedKVCache.init(cfg, SERVE_SLOTS, cmax, page_size=ps,
                                    layout=layout, device=dev)
    cache.seq_lens.copy_(torch.as_tensor(mid, device=dev))
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=dev)
    wall, busy, names, by_name = device_busy(
        lambda: paged.paged_decode_step(params, cfg, cache, tok,
                                        use_kernel=True), torch,
        want=("pdec::",))
    paged_ms = sum(ms for name, ms in by_name.items()
                   if "pdec::" in name or "splitk::" in name)
    print(f"[{label}] one decode step of {SERVE_SLOTS} requests at seq_len "
          f"{min(mid)}..{max(mid)}: {wall:.3f} ms on the host clock, device "
          f"busy {busy:.3f} ms (idle share {1 - busy / wall:.4f}); the paged "
          f"kernels (attend and combine) {paged_ms:.3f} ms, "
          f"{paged_ms / busy:.4f} of device busy; costliest kernels: {names}",
          flush=True)
    if not paged_ms:
        fail(f"{label}: the profiled step shows no paged kernel")
    return wall, busy, paged_ms


def run_serving(tier, torch, dev) -> dict:
    """``serve_continuous`` on granite-3-2b at full width (40 layers, 16
    requests over 8 slots, 64 tokens each, prompts up to 960 tokens, the
    kernel certified first), in bfloat16 (the model's type) and in
    float32, each held against the teacher-forced dense oracle
    (``check_tokens``), the bfloat16 check also against a faulted run
    (``faulted_serving``); then one decode step at the serving shapes
    profiled, and the kernel timed there.  Returns the kernel row at the
    serving shapes with the bfloat16 run's launch count."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config("granite-3-2b")
    lens = serve_lens(50)
    max_ctx = max(lens) + SERVE_GEN
    blocks, plan = ops.resolve_plan("paged_decode", max_ctx, cfg.head_dim,
                                    cfg.n_heads // cfg.n_kv_heads, cfg.dtype,
                                    device=dev)
    print(f"[serving] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}; "
          f"{SERVE_REQUESTS} requests, prompts {lens}, {SERVE_SLOTS} slots, "
          f"{SERVE_GEN} tokens each; DSE plan for paged_decode({max_ctx}, "
          f"{cfg.head_dim}): (layout, page size, block, depth) = {blocks}, "
          f"on-chip bytes {plan.vmem_bytes}", flush=True)
    out = {}
    for dtype in ("bfloat16", "float32"):
        what = f"serving[{dtype}]"
        params = make_params(what, cfg.with_(dtype=dtype), torch, dev)
        toks, stats, launches = serve_once(cfg.with_(dtype=dtype), lens,
                                           params, torch, dev, what)
        ps = stats["page_size"]
        cmax = -(-max_ctx // ps) * ps
        check_tokens(cfg, params, lens, toks, cmax, dtype, torch, dev)
        if dtype == "bfloat16":
            faulted_serving(cfg, params, lens, cmax, stats["layout"], ps,
                            torch, dev, "serving[bfloat16,append skipped]")
        out[dtype] = (stats, launches)
        if dtype == "bfloat16":
            profile_step("serving", cfg, params, lens, cmax, ps,
                         stats["layout"], torch, dev)
        del params
        torch.cuda.empty_cache()
    stats, launches = out["bfloat16"]
    row = run_paged(f"paged_decode[granite,serving,{stats['layout']},"
                    f"p{stats['page_size']}]", cfg,
                    [lens[i % len(lens)] + SERVE_GEN // 2
                     for i in range(SERVE_SLOTS)],
                    stats["page_size"], cmax // stats["page_size"],
                    stats["layout"], 51, tier, torch, dev)
    row["launches"] = launches
    return row


# ------------------------------------------------------- the MoE family
MOE_ARCH = "llama4-maverick-400b-a17b"
MOE_LAYERS = 2               # one dense layer, one MoE layer
MOE_EXPERTS = 128
ROUTER_LABEL = "groupby_fold[llama4,router]"
ROUTER_PROMPTS = (2, 512)    # the router's prefill: 1,024 tokens
MIXTRAL = "mixtral-8x22b"
MIXTRAL_TOKENS = (2, 4096)   # two routing groups of 4096 tokens
MOE_TOL = 2e-2               # bfloat16, atol x the largest magnitude


def moe_reckoning(cfg, tier) -> int:
    """Print the cut model's parameters and bytes, its three expert
    tensors, and the peak ``init_params`` should reach (each tensor drawn
    in float32, scaled in place, then cast); returns the bytes a decode
    step reads: every weight but the embedding table."""
    import math

    from repro_torch.models import model

    shapes = model.param_shapes(cfg)
    n = sum(math.prod(s) for s, _ in shapes.values())
    experts = [name for name in shapes if name[4:] in ("we1", "we2", "we3")]
    ex = math.prod(shapes[experts[0]][0])
    made = peak = 0
    for name, (shape, _) in sorted(shapes.items()):
        size = math.prod(shape)
        peak = max(peak, made + 6 * size)
        made += 2 * size
    step = 2 * (n - math.prod(shapes["embed"][0]))
    print(f"[moe] {cfg.name} at its published widths cut to {cfg.n_layers} "
          f"layers (one dense, one MoE): {n} parameters, {2 * n / 1e9:.2f} GB"
          f" in bf16; the three expert tensors {shapes[experts[0]][0]} "
          f"{2 * ex / 1e9:.2f} GB each; init_params' peak about "
          f"{peak / 1e9:.1f} GB (a float32 draw scaled in place and its bf16 "
          f"copy beside the {made / 1e9:.1f} GB kept); a decode step reads "
          f"every weight but the embedding table, {step / 1e9:.2f} GB "
          f"({3 * 2 * ex / 1e9:.2f} GB of it the {cfg.n_experts} experts, "
          "which the capacity dispatch computes whatever the routing): "
          f"{step / tier.hbm_bytes_per_s * 1e3:.3f} ms at "
          f"{tier.hbm_bytes_per_s / 1e12:.2f} TB/s", flush=True)
    return step


def run_router(cfg, params, tier, torch, dev) -> dict:
    """``moe.router_counts(use_kernel=True)`` on the hidden states that
    enter the MoE layer in a prefill of ROUTER_PROMPTS tokens (captured
    from ``moe_ffn``'s input): ``groupby_fold`` over 128 experts at the
    form ``table_form`` gives, its launch count reset just before and read
    just after; the counts exactly the plain version's and the ``ref``
    oracle's (``use_kernel=False``), two calls bitwise equal, after
    proving exact equality catches one dropped row; timed beside the
    plain version and ``index_add_``."""
    from repro_torch.kernels import groupby_fold as gbf
    from repro_torch.kernels import ops
    from repro_torch.models import model, moe

    label = ROUTER_LABEL
    b, s = ROUTER_PROMPTS
    prompt = torch.as_tensor(np.random.RandomState(64).randint(
        0, cfg.vocab, (b, s)), dtype=torch.int32, device=dev)
    seen = []
    real = moe.moe_ffn
    moe.moe_ffn = lambda p, x, c: seen.append(x) or real(p, x, c)
    try:
        model.decode_step(params, cfg, model.init_cache(cfg, b, s, device=dev),
                          prompt, 0)
    finally:
        moe.moe_ffn = real
    if len(seen) != 1:
        fail(f"{label}: the prefill ran {len(seen)} MoE layers, expected 1")
    h = seen[0]
    layer = {k[4:]: v[0] for k, v in params.items() if k.startswith("moe_")}
    e = cfg.n_experts
    form = keyed_form(label, e, 1, dev, torch)
    torch.cuda.synchronize()
    gbf.groupby_fold.launches = 0
    got = moe.router_counts(layer, h, cfg, use_kernel=True)
    torch.cuda.synchronize()
    launches = gbf.groupby_fold.launches
    ran_form(label, gbf.groupby_fold.form, form)
    keys = torch.argmax(h.reshape(b * s, -1).float() @ layer["router"]
                        .float(), dim=-1).to(torch.int32)
    ones = torch.ones(b * s, device=dev)
    plain = gbf.groupby_fold_plain(keys, ones, e)
    ref = moe.router_counts(layer, h, cfg, use_kernel=False)
    dropped = keys.clone()
    dropped[int(torch.argmax(got[keys.long()]))] = -1     # a busy expert
    if torch.equal(got, gbf.groupby_fold_plain(dropped, ones, e)):
        fail(f"{label}: exact equality would not catch a dropped row")
    for what, want in (("plain", plain), ("ref", ref)):
        if not torch.equal(got, want):
            fail(f"{label}: counts differ from the {what} version by "
                 f"{float((got - want).abs().max())}")
    if not torch.equal(got, moe.router_counts(layer, h, cfg,
                                              use_kernel=True)):
        fail(f"{label}: two calls differ")
    if launches < 1 or float(got.sum()) != b * s:
        fail(f"{label}: {launches} launches, {float(got.sum())} counted")
    busy = int((got > 0).sum())
    print(f"[{label}] {b} x {s} prefill tokens of {cfg.name}'s MoE layer "
          f"into {e} experts ({busy} used, the largest "
          f"{int(got.max())}): groupby_fold launches={launches}, counts "
          "exactly the plain version's and the ref oracle's, two calls "
          "bitwise equal; planted fault caught: a dropped row", flush=True)

    def run():
        return ops.groupby(keys, ones, e)
    ms = median_ms(run, torch)
    plain_ms = median_ms(lambda: gbf.groupby_fold_plain(keys, ones, e),
                         torch)
    lib_ms = median_ms(lambda: torch.zeros(e, device=dev).index_add_(
        0, keys, ones), torch)
    nbytes = nbytes_of(keys, ones) + 4 * e
    bound_ms, by = bound(nbytes, b * s, tier)
    print(f"[{label}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{lib_ms:.4f} ms (index_add_), bound {bound_ms:.3g} ms ({nbytes} "
          f"B, {b * s} ops)", flush=True)
    breakdown(label, run, [f"{form}_kernel", "combine_partials"], torch)
    return {"name": label, "route": "cuda",
            "source": f"{CSRC}/groupby_fold.cuh",
            "replaces": f"{HAND}/groupby_fold.py:43", "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


def run_moe_serving(tier, torch, dev) -> list:
    """Llama-4 Maverick at its published widths, cut to MOE_LAYERS
    layers, served through ``_serve_continuous`` (16 requests over 8
    slots, prompts up to 960 tokens, 64 tokens each, the card's paged
    plan): the planted fault first (the kernel's append skipped:
    certification must raise and the faulted tokens fail the bf16 rule),
    then the served run (kernel certified first) held against the
    teacher-forced dense oracle by the bf16 rule, one step profiled
    beside its byte floor, the router's ``groupby_fold`` on a prefill's
    hidden states, and the kernel timed at the serving shapes.  Returns
    the kernel rows."""
    from repro_torch.configs import get_config
    from repro_torch.core import codegen_cuda as cc
    from repro_torch.kernels import ops

    cfg = get_config(MOE_ARCH).with_(n_layers=MOE_LAYERS)
    group = cfg.n_heads // cfg.n_kv_heads
    lens = serve_lens(60)
    max_ctx = max(lens) + SERVE_GEN
    blocks, plan = ops.resolve_plan("paged_decode", max_ctx, cfg.head_dim,
                                    group, cfg.dtype, device=dev)
    layout, ps = blocks[0], blocks[1]
    charge = cc.pd_smem_bytes(cc.PD_STAGES, cc.PD_KC,
                              cc.pd_launch_group(group), cfg.head_dim,
                              cfg.dtype)
    print(f"[moe] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim} (group {group}), d_ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts top-{cfg.top_k}, shared "
          f"expert {cfg.shared_expert}, vocab {cfg.padded_vocab}; "
          f"{SERVE_REQUESTS} requests, prompts {lens}, {SERVE_SLOTS} slots, "
          f"{SERVE_GEN} tokens each; DSE plan for paged_decode({max_ctx}, "
          f"{cfg.head_dim}, group {group}, {cfg.dtype}): (layout, page size, "
          f"block, depth) = {blocks}, on-chip bytes {plan.vmem_bytes} (the "
          f"kernel's smem_bytes: {charge})", flush=True)
    if plan.vmem_bytes != charge or blocks[2:] != (cc.PD_KC, cc.PD_STAGES):
        fail(f"moe: the plan charges {plan.vmem_bytes} B at {blocks[2:]}, "
             f"the kernel stages {charge} B at ({cc.PD_KC}, {cc.PD_STAGES})")
    step_bytes = moe_reckoning(cfg, tier)
    params = make_params("moe", cfg, torch, dev)
    cmax = -(-max_ctx // ps) * ps
    faulted_serving(cfg, params, lens, cmax, layout, ps, torch, dev,
                    "moe[serving,append skipped]")
    what = "moe[serving]"
    toks, stats, launches = serve_once(cfg, lens, params, torch, dev, what)
    check_tokens(cfg, params, lens, toks, cmax, cfg.dtype, torch, dev, what)
    wall, busy, paged_ms = profile_step(what, cfg, params, lens, cmax, ps,
                                        layout, torch, dev)
    mid = [lens[i % len(lens)] + SERVE_GEN // 2 for i in range(SERVE_SLOTS)]
    kv = sum(-(-(n + 1) // ps) * ps for n in mid) * cfg.n_layers * 2 \
        * cfg.n_kv_heads * cfg.head_dim * 2
    floor_ms = (step_bytes + kv) / tier.hbm_bytes_per_s * 1e3
    print(f"[{what}] byte floor of a step: {step_bytes} B of weights + {kv} "
          f"B of live K/V = {floor_ms:.3f} ms at "
          f"{tier.hbm_bytes_per_s / 1e12:.2f} TB/s; the profiled step's "
          f"device busy {busy:.3f} ms ({busy / floor_ms:.2f}x the floor), "
          f"host clock {wall:.3f} ms", flush=True)
    rows = [run_router(cfg, params, tier, torch, dev)]
    del params
    torch.cuda.empty_cache()
    row = run_paged(f"paged_decode[llama4,serving,{layout},p{ps}]", cfg, mid,
                    ps, cmax // ps, layout, 61, tier, torch, dev)
    row["launches"] = launches
    return [row] + rows


def run_moe_paged(tier, torch, dev) -> list:
    """``lower_paged_decode`` at Llama-4 Maverick's attention widths (8 kv
    heads, group 5, head dim 128, bf16 pools): 32 requests of seeded
    lengths up to 8,191 tokens at the card's plan's page size, both
    layouts (``run_paged``: planted faults first, bound and ratio)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config(MOE_ARCH)
    (_, ps, _, _), _ = ops.resolve_plan(
        "paged_decode", PD_CTX, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
        cfg.dtype, device=dev)
    lens = paged_lens(ps, np.random.RandomState(62))
    return [run_paged(f"paged_decode[llama4,{layout},p{ps}]", cfg, lens, ps,
                      PD_CTX // ps, layout, 63, tier, torch, dev)
            for layout in ("split", "fused")]


def run_mixtral_layer(torch, dev) -> None:
    """One MoE layer of mixtral-8x22b at its published widths (d_model
    6144, d_ff 16384, 8 experts, top-2) in bf16 on 2 x 4096 tokens (two
    routing groups), random weights from a seed, held against the same
    layer in float64 on the routing of the run under test (captured from
    ``moe.route``) by the bf16 rule of ``tests/test_torch_moe.py``: rtol
    MOE_TOL and an atol of MOE_TOL x the oracle's largest magnitude,
    after proving that limit catches one token's second choice dropped
    (the error over each token's root mean square is printed beside it).
    Prints each token's margin between its k-th and (k+1)-th logit; a
    routing that differs from a float32 run's must be a tie (margin
    within float32 rounding of the logit)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe

    label = "moe[mixtral]"
    cfg = get_config(MIXTRAL)
    b, s = MIXTRAL_TOKENS
    gen = torch.Generator(device=dev).manual_seed(70)
    p = {name: L.dense_init(gen, shape[1:], -2, torch.bfloat16, dev)
         for name, shape in sorted(moe.param_shapes(cfg, 1).items())}
    x = lm_randn((b, s, cfg.d_model), 71, torch, dev).to(torch.bfloat16)
    seen = []
    real = moe.route

    def record(logits, c, cap):
        out = real(logits, c, cap)
        seen.append((logits,) + out)
        return out
    moe.route = record
    try:
        t0 = time.perf_counter()
        y = moe.moe_ffn(p, x, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        moe.moe_ffn({k: v.float() for k, v in p.items()}, x.float(),
                    cfg.with_(dtype="float32"))
    finally:
        moe.route = real
    (logits, topi, gates, dest), (_, topi32, _, dest32) = seen
    k, e = cfg.top_k, cfg.n_experts
    g, gsz = logits.shape[:2]
    cap = moe.capacity(cfg, gsz)
    vals = moe.top_k(logits, k + 1)[0]
    margin = (vals[..., k - 1] - vals[..., k]).reshape(-1)
    ulp = torch.finfo(torch.float32).eps * vals[..., k - 1].abs().reshape(-1)
    order = torch.argsort(margin)
    differ = (topi != topi32).any(-1).reshape(-1)
    print(f"[{label}] {cfg.name}: d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"{e} experts top-{k}, {b} x {s} tokens in {g} routing groups of "
          f"{gsz}, capacity {cap}; {int((dest == e * cap).sum())} choices "
          f"dropped; margin between each token's {k}th and {k + 1}th logit: "
          f"min {float(margin.min()):.4g}, median "
          f"{float(margin.median()):.4g}, {int((margin < 1e-3).sum())} "
          f"below 1e-3; the smallest five "
          + ", ".join(f"token {int(i)}: {float(margin[i]):.3g}"
                      for i in order[:5])
          + f"; routing of a float32 run differs in {int(differ.sum())} "
          "tokens", flush=True)
    for i in torch.nonzero(differ).reshape(-1).tolist():
        print(f"[{label}] token {i}: routing differs from the float32 run's,"
              f" margin {float(margin[i]):.4g} (float32 rounding of its "
              f"logit {float(ulp[i]):.4g})")
        if margin[i] > ulp[i]:
            fail(f"{label}: token {i}'s routing differs from the float32 "
                 f"run's at a margin of {float(margin[i]):.4g}, past float32 "
                 "rounding: not a tie")
    if not differ.any() and not torch.equal(dest, dest32):
        fail(f"{label}: dispatch slots differ from the float32 run's")
    p64 = {k_: v.double() for k_, v in p.items()}
    xt = x.double().reshape(g, gsz, cfg.d_model)
    gates64 = torch.softmax(torch.einsum("gtd,de->gte", xt, p64["router"])
                            .gather(-1, topi), dim=-1)
    want = moe.experts(p64, xt, gates64, dest, cfg).reshape(y.shape)
    atol = MOE_TOL * float(want.abs().max())
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    # the planted fault: the token with the heaviest second choice loses it
    tok = int(torch.argmax(gates64[..., 1]))
    faulted_dest = dest.clone().reshape(-1, k)
    faulted_dest[tok, 1] = e * cap
    faulted = moe.experts(p64, xt, gates64, faulted_dest.reshape(dest.shape),
                          cfg).reshape(y.shape)
    shift = float((faulted - want).abs().max())
    if not catches(faulted, want, MOE_TOL, atol):
        fail(f"{label}: rtol {MOE_TOL} / atol {fmt_atol(atol)} would not "
             f"catch token {tok}'s second choice dropped (shift {shift:.4g})")
    del faulted, faulted_dest, p64
    err = check_close(y, want, MOE_TOL, atol, torch, f"{label} vs float64")
    per_rms = float(((y.double() - want).abs() / rms.clamp_min(1e-300))
                    .max())
    ms = median_ms(lambda: moe.moe_ffn(p, x, cfg), torch, LM_REPS, LM_BATCH)
    print(f"[{label}] bf16 layer vs float64 on its routing: max abs err "
          f"{err:.4g} (at most {per_rms:.4g} of its token's root mean "
          f"square); rtol {MOE_TOL}, atol {fmt_atol(atol)}; planted fault "
          f"caught: token {tok}'s second choice dropped shifts it by "
          f"{shift:.4g}; the layer (torch.einsum on cuBLAS, no hand kernel) "
          f"{ms:.3f} ms a call, first call {first_s:.3f} s", flush=True)


def run_moe(tier, torch, dev) -> list:
    """The ``[moe]`` phase: Llama-4 Maverick served at full width (two
    layers), row 6 at its attention widths, row 10 as its router, and a
    Mixtral MoE layer at full width.  Returns the kernel rows."""
    t0 = time.perf_counter()
    rows = run_moe_serving(tier, torch, dev)
    rows.extend(run_moe_paged(tier, torch, dev))
    torch.cuda.empty_cache()
    run_mixtral_layer(torch, dev)
    torch.cuda.empty_cache()
    print(f"[moe] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


# ------------------------------------------------------- bucketed serving
BUCKET_ARCH = "qwen2-72b"
BUCKET_LAYERS = 2            # of qwen2-72b's 80
BUCKET_LENS = (100, 100, 110, 110)   # two prompt groups, one bucket
BUCKET_GEN = 8


def run_buckets(torch, dev) -> None:
    """``[buckets]``: ``serve(bucketing=True)`` of qwen2-72b at its
    published widths cut to BUCKET_LAYERS layers (random bf16 weights
    made on the card) on prompts of 100 and 110 tokens: the 100-token
    group's attention plan (the card's own, at head dim 128) misses and
    is explored; the 110-token group lies in the same bucket and is
    warm-started, nothing built in the foreground, while a background
    re-tune certifies the exact plan by running the kernel on the card
    and promotes it.  After ``drain`` and a cleared plan memo (a fresh
    process's view: the tuning cache alone), a second serve of the same
    lengths is all exact hits.  Fails unless the counts are these, every
    certification ran on the card and passed, and both serves return the
    same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core import buckets, resilience
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    cfg = get_config(BUCKET_ARCH).with_(n_layers=BUCKET_LAYERS)
    print(f"[buckets] {cfg.name} cut to {cfg.n_layers} layers: d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.padded_vocab}; prompts "
          f"{list(BUCKET_LENS)}, {BUCKET_GEN} tokens each", flush=True)
    params = make_params("buckets", cfg, torch, dev)
    certs = []
    real = resilience.certify_attention_plan

    def recording(*a, **k):
        ok, why = real(*a, **k)
        certs.append((a[:5], str(k.get("device")), ok, why))
        return ok, why

    resilience.certify_attention_plan = recording
    try:
        buckets.reset_stats()
        ops.clear_plan_memo()
        builds = build.compile_all.builds
        first = {}
        toks = serve._serve(cfg, len(BUCKET_LENS), 0, BUCKET_GEN,
                            prompt_lens=BUCKET_LENS, bucketing=True,
                            params=params, device=dev, stats_out=first)
        fg_builds = build.compile_all.builds - builds
        buckets.drain(timeout=300.0)
        after = buckets.stats()
        ops.clear_plan_memo()
        second = {}
        toks2 = serve._serve(cfg, len(BUCKET_LENS), 0, BUCKET_GEN,
                             prompt_lens=BUCKET_LENS, bucketing=True,
                             params=params, device=dev, stats_out=second)
        buckets.drain(timeout=300.0)
    finally:
        resilience.certify_attention_plan = real
    for name, st in (("first", first), ("second", second)):
        for row in st["plans"]:
            print(f"[buckets] {name} serve: {row}")
    d1, d2 = first["plans"][-1]["bucket_stats"], second["plans"][-1][
        "bucket_stats"]
    rows1, rows2 = first["plans"][:-1], second["plans"][:-1]
    print(f"[buckets] first serve: {d1['misses']} miss, {d1['warm_hits']} "
          f"warm start, {d1['exact_hits']} exact hits (hit rate "
          f"{first['plans'][-1]['bucket_hit_rate']:.4f}), {fg_builds} nvcc "
          f"builds in the foreground; re-tunes {after['retunes']}, "
          f"promotions {after['promotions']}, failures "
          f"{after['retune_failures']}; certifications: "
          + "; ".join(f"{a} on {where}: {'passed' if ok else 'FAILED'} "
                      f"({why})" for a, where, ok, why in certs))
    print(f"[buckets] second serve: {d2['exact_hits']} exact hits of "
          f"{len(rows2)} groups (hit rate "
          f"{second['plans'][-1]['bucket_hit_rate']:.4f}); phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    if (d1["misses"], d1["warm_hits"], d1["exact_hits"]) != (1, 1, 0) \
            or rows1[0]["warm_start"] or not rows1[1]["warm_start"]:
        fail(f"buckets: the first serve should miss once and warm-start "
             f"once: {d1}")
    if fg_builds:
        fail(f"buckets: {fg_builds} builds in the foreground")
    if (after["retunes"], after["promotions"],
            after["retune_failures"]) != (1, 1, 0):
        fail(f"buckets: re-tunes {after}")
    if len(certs) != after["promotions"] or not all(
            ok and where.startswith("cuda") for _, where, ok, _ in certs):
        fail(f"buckets: promotions not all certified on the card: {certs}")
    if d2["exact_hits"] != len(rows2) or d2["misses"] or d2["warm_hits"] \
            or not all(r["cached"] and not r["warm_start"] for r in rows2):
        fail(f"buckets: the second serve should be all exact hits: {d2}")
    if not np.array_equal(toks, toks2):
        fail("buckets: the two serves returned different tokens")


# ------------------------------------------- the SSM and hybrid families
FAMILY_GEN = 32
# 16 requests in three prompt groups; each prompt + FAMILY_GEN is a whole
# number of the chunked SSD's 64-step chunks, as the oracle's forward
# needs
FAMILY_LENS = (32,) * 6 + (96,) * 5 + (160,) * 5


def plain_ssd_chunked(x, dt, A, B, C, chunk=None):
    """``ssm.ssd_chunked`` for the oracle: the same chunked parallel form
    through ``ssd_scan_plain`` (the kernel's plain version, float32, no
    rounding of the intra-chunk operands to bfloat16); no final state."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    return ssd_scan_plain(x, dt, A, B, C, chunk=chunk or 64), None


def family_oracle(cfg, params, lens, toks, first, torch, dev) -> list:
    """Per request, the teacher-forced oracle's logits (pad vocab masked,
    float32) scoring its prefill token and its served tokens: one
    ``model.forward`` over the prompt, the prefill token and the served
    tokens but the last, in the served type, its SSD in the chunked
    parallel form (``plain_ssd_chunked``) -- independent of the served
    step, which carries the recurrence token by token (and, for the
    attention families, of the served step's KV cache).  Row t scores
    token t of ``[first] + toks`` (codebook frames: row t is (n_cb, V))."""
    from repro_torch.models import model, ssm

    ncb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    pool = np.random.RandomState(0).randint(0, cfg.vocab,
                                            (len(lens), max(lens)) + ncb)
    real = ssm.ssd_chunked
    ssm.ssd_chunked = plain_ssd_chunked
    rows = [None] * len(lens)
    try:
        with torch.no_grad():
            for ln in sorted(set(lens)):
                rs = [r for r, n in enumerate(lens) if n == ln]
                seq = np.concatenate([pool[rs, :ln], first[rs, None],
                                      toks[rs, :-1]], 1)
                logits = model.forward(params, cfg, {"tokens": torch.as_tensor(
                    seq, dtype=torch.int32, device=dev)})
                masked = model.mask_vocab_pad(logits, cfg)[:, ln - 1:].float()
                for i, r in enumerate(rs):
                    rows[r] = masked[i]
    finally:
        ssm.ssd_chunked = real
    return rows


def bf16_drift(cfg, params, lens, toks, first, rows, torch, dev) -> list:
    """Per request, the oracle's own bfloat16 error at every scored step
    and token: its bfloat16 logits (``rows``) less the same oracle's
    float32 logits on the same weights (pad columns zero).  Over 48 or
    more recurrent layers two correct bfloat16 computations of a logit
    drift apart by more than the bf16 tolerance (on an H100, mamba2-370m
    at 48 layers: 0.15-0.4 on logits near 4; the oracle's largest error
    a step 0.73 to 2.7, its median 0.18)."""
    p32 = {k: v.float() for k, v in params.items()}
    rows32 = family_oracle(cfg.with_(dtype="float32"), p32, lens, toks,
                           first, torch, dev)
    del p32
    out = []
    for r, r32 in zip(rows, rows32):
        d = (r - r32).abs()
        d[..., cfg.vocab:] = 0.0             # the pad columns are -1e30
        out.append(d)
    return out


def family_misses(rows, toks, first, dtype: str, drift=None) -> tuple:
    """Per request, the first step of its prefill token and served tokens
    that the rule refuses, or None, and how many pass: float32 must be
    the oracle's greedy token; bfloat16 one the oracle scores within the
    bf16 tolerance of its best or, where larger, within the largest bf16
    error the oracle itself makes on a logit of that step (``drift``).
    A tighter limit, twice the oracle's own error on the two logits
    compared, refused 3 of 528 correct bfloat16 tokens of mamba2-370m on
    an H100 by 0.07-0.3: the served run's own bf16 error at a token is
    not the oracle's."""
    ext = np.concatenate([first[:, None], toks], 1)
    if dtype == "float32":
        return first_misses([(r, None) for r in rows], ext, dtype)
    from repro_torch.launch import serve
    rtol, atol = serve.TOLERANCES[dtype]
    misses, passed = [], 0
    for r, logits in enumerate(rows):
        best = logits.max(-1).values
        index = torch_index(ext[r], logits)
        got = logits.gather(1, index)[:, 0]
        limit = atol + rtol * best.abs()
        if drift is not None:
            limit = limit.maximum(drift[r].amax(-1))
        ok = (got >= best - limit).cpu().numpy()
        passed += int(ok.sum())
        bad = np.flatnonzero(~ok)
        misses.append(None if not bad.size else (int(bad[0]), (
            f"request {r} token {int(bad[0]) - 1}: {int(ext[r, bad[0]])} "
            f"scores {float(got[bad[0]]):.4g}, the oracle's "
            f"{int(logits[bad[0]].argmax())} {float(best[bad[0]]):.4g} "
            f"(limit {float(limit[bad[0]]):.4g})")))
    return misses, passed


def torch_index(values, like):
    """``values`` as a column of int64 indices on ``like``'s device."""
    import torch
    return torch.as_tensor(values, dtype=torch.int64,
                           device=like.device)[:, None]


def serve_family(cfg, params, lens, torch, dev) -> tuple:
    from repro_torch.launch import serve
    stats = {}
    toks = serve._serve(cfg, len(lens), 0, FAMILY_GEN, prompt_lens=lens,
                        params=params, device=dev, stats_out=stats)
    torch.cuda.synchronize()
    return toks, stats


def conv_state_dropped():
    """A planted fault of the recurrent path: the causal conv ignores the
    state carried from the step before.  Returns a function that undoes
    it."""
    from repro_torch.models import layers

    real = layers.causal_conv1d
    layers.causal_conv1d = lambda x, w, state=None: real(x, w, None)

    def undo():
        layers.causal_conv1d = real
    return undo


def family_step(label: str, cfg, params, torch, dev, tier) -> None:
    """One decode step of the first group's batch (6 requests) halfway
    through its context, under torch.profiler: host ms, device busy ms,
    the idle share, kernel launches per step, and the step's byte floor
    (every weight but the embedding table, plus the live K/V of the
    hybrid's shared block, over the tier's bandwidth)."""
    from repro_torch.models import model

    b, ctx = FAMILY_LENS.count(FAMILY_LENS[0]), FAMILY_LENS[0] + FAMILY_GEN
    index = FAMILY_LENS[0] + FAMILY_GEN // 2
    cache = model.init_cache(cfg, b, ctx, device=dev)
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    tok = torch.zeros((b, 1) + ncb, dtype=torch.int32, device=dev)

    def step():
        with torch.no_grad():
            return model.decode_step(params, cfg, cache, tok, index)
    wall, busy, names, _ = device_busy(step, torch)
    kernels = device_kernels(step, torch)
    launches = sum(count for _, _, count in kernels) / 3
    weights = sum(t.numel() * t.element_size() for n, t in params.items()
                  if n != "embed")
    kv = 0
    if "k" in cache:
        kv = 2 * cache["k"][:, :, :, :index + 1].numel() \
            * cache["k"].element_size()
    floor_ms = (weights + kv) / tier.hbm_bytes_per_s * 1e3
    print(f"[{label}] one decode step of {b} requests at position {index}: "
          f"{wall:.3f} ms on the host clock, device busy {busy:.3f} ms (idle "
          f"share {1 - busy / wall:.4f}), {launches:.0f} kernel launches a "
          f"step; byte floor {weights} B of weights + {kv} B of live K/V = "
          f"{floor_ms:.3f} ms at {tier.hbm_bytes_per_s / 1e12:.2f} TB/s "
          f"(busy {busy / floor_ms:.2f}x it); costliest kernels: {names}",
          flush=True)
    if not busy:
        fail(f"{label}: the profiled step shows no device time")


def run_family(tag: str, arch: str, tier, torch, dev) -> None:
    """``[ssm]`` / ``[hybrid]``: ``arch`` at its published widths, random
    weights made on the card, served through ``serve`` (the dense-cache
    path: a token scan prefills each prompt group, then FAMILY_GEN greedy
    decode steps) on FAMILY_LENS, in bfloat16 and float32.  In bfloat16
    the token rule is first shown to reject a planted fault (the conv
    state not carried from one step to the next, over the first group);
    then each served run is held to the teacher-forced oracle
    (``family_oracle``): float32 tokens identical, bfloat16 within the
    bf16 tolerance of the oracle's best.  Prints decode ms per token and
    per step, prefill s, and one profiled step (``family_step``)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    base = get_config(arch)
    lens = list(FAMILY_LENS)
    extra = (f"; shared block: {base.n_heads} heads of {base.head_dim} "
             f"every {base.shared_attn_every} layers, d_ff {base.d_ff}, "
             f"{base.activation}" if base.family == "hybrid" else "")
    print(f"[{tag}] {base.name}: {base.n_layers} layers, d_model "
          f"{base.d_model}, {base.ssm_heads} SSM heads of "
          f"{base.ssm_head_dim}, state {base.ssm_state}, conv "
          f"{base.ssm_conv}, vocab {base.vocab} + {base.vocab_pad}{extra}; "
          f"{len(lens)} requests, prompts {sorted(set(lens))} "
          f"({len(set(lens))} groups), {FAMILY_GEN} tokens each", flush=True)
    for dtype in ("bfloat16", "float32"):
        cfg = base.with_(dtype=dtype)
        what = f"{tag}[{dtype}]"
        params = make_params(what, cfg, torch, dev)
        if dtype == "bfloat16":
            group = lens[:lens.count(lens[0])]
            undo = conv_state_dropped()
            try:
                bad, bad_stats = serve_family(cfg, params, group, torch, dev)
            finally:
                undo()
            rows = family_oracle(cfg, params, group, bad,
                                 bad_stats["first_tokens"], torch, dev)
            drift = bf16_drift(cfg, params, group, bad,
                               bad_stats["first_tokens"], rows, torch, dev)
            misses, passed = family_misses(rows, bad,
                                           bad_stats["first_tokens"], dtype,
                                           drift)
            caught = sum(m is not None for m in misses)
            print(f"[{what}] planted fault (the conv state not carried): "
                  f"the bf16 rule rejects {caught} of {len(group)} requests;"
                  f" {passed} of {bad.size + len(group)} faulted tokens lie "
                  f"within the rule's limit of the oracle's best",
                  flush=True)
            if not caught:
                fail(f"{what}: the token rule passes a served run whose conv "
                     "state is not carried")
        toks, stats = serve_family(cfg, params, lens, torch, dev)
        steps = len(set(lens)) * FAMILY_GEN
        print(f"[{what}] prefill {stats['prefill_s']:.3f} s (token scans of "
              f"{sorted(set(lens))}), decode {stats['decode_s']:.3f} s over "
              f"{steps} steps: {stats['decode_s'] / steps * 1e3:.3f} ms per "
              f"step, {stats['ms_per_token']:.3f} ms per token", flush=True)
        if toks.shape != (len(lens), FAMILY_GEN) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            fail(f"{what}: tokens of shape {toks.shape} in "
                 f"[{toks.min()}, {toks.max()}]")
        t1 = time.perf_counter()
        rows = family_oracle(cfg, params, lens, toks, stats["first_tokens"],
                             torch, dev)
        drift = None
        if dtype == "bfloat16":
            drift = bf16_drift(cfg, params, lens, toks,
                               stats["first_tokens"], rows, torch, dev)
        misses, passed = family_misses(rows, toks, stats["first_tokens"],
                                       dtype, drift)
        ext = np.concatenate([stats["first_tokens"][:, None], toks], 1)
        same = sum(int((r.argmax(-1).cpu().numpy() == ext[i]).sum())
                   for i, r in enumerate(rows))
        gaps = [float((r.max(-1).values - r.gather(
            1, torch_index(ext[i], r))[:, 0]).max()) for i, r in enumerate(rows)]
        print(f"[{what}] teacher-forced oracle (forward, chunked SSD) in "
              f"{time.perf_counter() - t1:.1f} s: {same} of {ext.size} tokens "
              f"its greedy token, {passed} pass the {dtype} rule; largest "
              f"deficit of a served token's logit {max(gaps):.4g}"
              + ("" if drift is None else
                 f"; the oracle's own bf16 error, largest per step "
                 f"{min(float(d.amax(-1).min()) for d in drift):.4g}.."
                 f"{max(float(d.amax(-1).max()) for d in drift):.4g}, "
                 f"median {float(torch.cat([d[:, :cfg.vocab].reshape(-1) for d in drift]).median()):.4g}"),
              flush=True)
        bad = [text for m in misses if m for text in (m[1],)]
        if bad:
            fail(f"{what}: tokens differ from the oracle: " + "; ".join(bad))
        if dtype == "bfloat16":
            family_step(what, cfg, params, torch, dev, tier)
        del params
        torch.cuda.empty_cache()
    print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------- the audio and VLM families
def codebook_dropped():
    """A planted fault of the audio path: the last codebook's embedding
    left out of the sum.  Returns a function that undoes it."""
    from repro_torch.models import transformer as tr

    real = tr._embed_tokens

    def faulty(params, cfg, tokens):
        t = tokens.long()
        return sum(params["embed"][i][t[..., i]]
                   for i in range(cfg.n_codebooks - 1))
    tr._embed_tokens = faulty
    return lambda: setattr(tr, "_embed_tokens", real)


def last_cache_write_skipped():
    """A planted fault of the dense-cache path: the last layer writes its
    K/V into a copy of its cache slices, not the cache (its attention
    still sees the step's own keys).  Returns a function that undoes
    it."""
    from repro_torch.models import transformer as tr

    real = tr.super_blocks

    def faulty(params, cfg, *stacks):
        layers = list(real(params, cfg, *stacks))
        if stacks:
            layers[-1][0]["extra"] = tuple(t.clone()
                                           for t in layers[-1][0]["extra"])
        return iter(layers)
    tr.super_blocks = faulty
    return lambda: setattr(tr, "super_blocks", real)


def flat_rows(rows, toks, first, drift=None) -> tuple:
    """Codebook rows (steps, n_cb, V) and tokens (steps, n_cb) as one row
    and token per (step, codebook), so that ``family_misses`` holds every
    codebook; other rows as they are."""
    ext = np.concatenate([first[:, None], toks], 1)
    rows = [r.reshape(-1, r.shape[-1]) for r in rows]
    drift = None if drift is None else \
        [d.reshape(-1, d.shape[-1]) for d in drift]
    flat = ext.reshape(len(ext), -1)
    return rows, flat[:, 1:], flat[:, 0], drift


def media_check(cfg, params, lens, toks, stats, dtype: str, torch,
                dev) -> tuple:
    """Hold a served run's tokens, every codebook, to the teacher-forced
    oracle by the family rule; returns ``(misses, passed, scored)``."""
    first = stats["first_tokens"]
    rows = family_oracle(cfg, params, lens, toks, first, torch, dev)
    drift = bf16_drift(cfg, params, lens, toks, first, rows, torch, dev) \
        if dtype == "bfloat16" else None
    # family_misses puts the first token back ahead of the others
    rows, ftoks, ffirst, drift = flat_rows(rows, toks, first, drift)
    misses, passed = family_misses(rows, ftoks, ffirst, dtype, drift)
    return misses, passed, sum(r.shape[0] for r in rows)


def run_media(tag: str, arch: str, tier, torch, dev) -> None:
    """``[audio]`` / ``[vlm]``: ``arch`` at its published widths and
    depth, random weights made on the card, served on the dense cache
    through ``serve`` (a block prefill of each prompt group, then
    FAMILY_GEN greedy steps) on FAMILY_LENS, in bfloat16 and float32.
    In float32 the token rule is first shown to reject every request of
    the first group served with a planted fault (MusicGen: the last
    codebook's embedding dropped from the sum; InternVL: the last
    layer's cache write skipped); then each run's tokens on every
    codebook are held to the teacher-forced oracle: float32 identical,
    bfloat16 within the bf16 tolerance of the oracle's best or its own
    bf16 error.  Prints ms per token and per step, prefill seconds and
    one profiled decode step (``family_step``)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    base = get_config(arch)
    lens = list(FAMILY_LENS)
    ncb = (base.n_codebooks,) if base.n_codebooks else ()
    print(f"[{tag}] {base.name}: {base.n_layers} layers, d_model "
          f"{base.d_model}, {base.n_heads}/{base.n_kv_heads} heads of "
          f"{base.head_dim}, d_ff {base.d_ff} {base.activation}, vocab "
          f"{base.vocab} + {base.vocab_pad}"
          + (f", {base.n_codebooks} codebooks" if ncb else "")
          + (f", {base.frontend_tokens} frontend tokens (not served)"
             if base.frontend_tokens else "")
          + f"; {len(lens)} requests, prompts {sorted(set(lens))}, "
          f"{FAMILY_GEN} tokens each on the dense cache", flush=True)
    plant = codebook_dropped if ncb else last_cache_write_skipped
    for dtype in ("bfloat16", "float32"):
        cfg = base.with_(dtype=dtype)
        what = f"{tag}[{dtype}]"
        params = make_params(what, cfg, torch, dev)
        if dtype == "float32":
            group = lens[:lens.count(lens[0])]
            undo = plant()
            try:
                bad, bad_stats = serve_family(cfg, params, group, torch, dev)
            finally:
                undo()
            bad = bad_stats.get("codebook_tokens", bad)
            misses, passed, scored = media_check(
                cfg, params, group, bad, bad_stats, dtype, torch, dev)
            caught = sum(m is not None for m in misses)
            print(f"[{what}] planted fault ({plant.__name__.replace('_', ' ')}"
                  f"): the f32 rule rejects {caught} of {len(group)} "
                  f"requests; {passed} of {scored} faulted tokens are the "
                  "oracle's", flush=True)
            if caught != len(group):
                fail(f"{what}: the token rule passes {len(group) - caught} "
                     f"requests served with the planted fault")
        toks, stats = serve_family(cfg, params, lens, torch, dev)
        full = stats.get("codebook_tokens", toks)
        steps = len(set(lens)) * FAMILY_GEN
        print(f"[{what}] prefill {stats['prefill_s']:.3f} s (blocks of "
              f"{sorted(set(lens))}), decode {stats['decode_s']:.3f} s over "
              f"{steps} steps: {stats['decode_s'] / steps * 1e3:.3f} ms per "
              f"step, {stats['ms_per_token']:.3f} ms per token", flush=True)
        if full.shape != (len(lens), FAMILY_GEN) + ncb or full.min() < 0 \
                or full.max() >= cfg.vocab:
            fail(f"{what}: tokens of shape {full.shape} in "
                 f"[{full.min()}, {full.max()}]")
        if ncb and not (toks == full[..., 0]).all():
            fail(f"{what}: serve reports other tokens than codebook 0")
        t1 = time.perf_counter()
        misses, passed, scored = media_check(cfg, params, lens, full, stats,
                                             dtype, torch, dev)
        print(f"[{what}] teacher-forced oracle (forward) in "
              f"{time.perf_counter() - t1:.1f} s: {passed} of {scored} "
              f"tokens{' (every codebook)' if ncb else ''} pass the "
              f"{dtype} rule", flush=True)
        bad = [m[1] for m in misses if m]
        if bad:
            fail(f"{what}: tokens differ from the oracle: " + "; ".join(bad))
        if dtype == "bfloat16":
            family_step(what, cfg, params, torch, dev, tier)
        del params
        torch.cuda.empty_cache()
    print(f"[{tag}] phase {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ training
TRAIN_ARCH = "granite-3-2b"
TRAIN_STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_FIRST_TOL = 2e-2       # the first bf16 loss against a float32 forward
GRAD_ARCHS = ("granite-3-2b", "musicgen-medium", "internvl2-1b")
GRAD_LAYERS = 2
GRAD_BATCH, GRAD_SEQ = 2, 256
GRAD_TOL = 2e-3              # loss relative; gradients rtol, atol x RMS
UPDATE_TOL = 1e-5            # the AdamW update, relative in norm
RESTART_TOL = 1e-5           # the losses after a restore, relative


def train_batch(cfg, rows: int, seq: int, seed: int, dev) -> dict:
    """The token pipeline's first batch on the card, as
    ``launch.train`` feeds it (the VLM with zero prefix rows)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.train import _batch

    return _batch(TokenPipeline(vocab=cfg.vocab, global_batch=rows,
                                seq_len=seq, seed=seed,
                                n_codebooks=cfg.n_codebooks), cfg, dev)


def train_full(torch, dev) -> None:
    """granite-3-2b at full width and depth, bf16, remat on, through
    ``launch.train.train``: TRAIN_STEPS finite losses, the first within
    TRAIN_FIRST_TOL of a float32 forward of the same weights (seed 0,
    made again on the card) on the same batch; ms a step, tokens a
    second, peak memory; one more step profiled for its idle share."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model
    from repro_torch.optim import adamw

    cfg = get_config(TRAIN_ARCH)
    if not cfg.remat or cfg.dtype != "bfloat16":
        fail(f"train: {TRAIN_ARCH}'s config is not bf16 with remat")
    params = make_params("train", cfg, torch, dev)
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, 0, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        p32 = {k: v.float() for k, v in params.items()}
        ref = float(model.loss(p32, cfg.with_(dtype="float32"), batch))
    del p32, params
    torch.cuda.empty_cache()
    print(f"[train] float32 forward of the same weights: loss {ref:.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    losses, params = train_mod.train(
        TRAIN_ARCH, False, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, None,
        log_every=1, seed=0, device=dev, stats_out=stats)
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = sorted(t * 1e3 for t in stats["step_s"][1:])
    med = step_ms[len(step_ms) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] {TRAIN_ARCH}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, bf16, remat on; {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses "
          f"{[round(x, 6) for x in losses]}; step ms "
          f"{[round(t * 1e3, 1) for t in stats['step_s']]} (median of "
          f"steps 2..{TRAIN_STEPS} {med:.1f} ms, {tokens / med * 1e3:.0f} "
          f"tokens/s); peak device memory {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        fail(f"train: losses {losses}")
    rel = abs(losses[0] - ref) / abs(ref)
    print(f"[train] first loss {losses[0]:.6f} vs float32 forward "
          f"{ref:.6f}: relative {rel:.3g} (limit {TRAIN_FIRST_TOL})")
    if rel > TRAIN_FIRST_TOL:
        fail(f"train: first loss {losses[0]} is {rel:.3g} from the float32 "
             f"forward's {ref}")
    opt = adamw.AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    state = adamw.init(params, opt)
    step = steps.make_train_step(cfg, opt)
    wall, busy, names, _ = device_busy(lambda: step(params, state, batch),
                                       torch, calls=1)
    print(f"[train] one profiled step: {wall:.1f} ms on the host clock, "
          f"device busy {busy:.1f} ms (idle share "
          f"{1 - busy / wall:.4f}); costliest kernels: {names}", flush=True)
    del params, state
    torch.cuda.empty_cache()


def grad_error(loss, grads, loss64, grads64) -> tuple:
    """(loss relative error, worst gradient leaf by |g - g64| over rtol
    x |g64| + atol x RMS(g64), its name): the step passes when the
    first is at most GRAD_TOL and the second at most 1."""
    rel = abs(float(loss) - float(loss64)) / abs(float(loss64))
    worst, name = 0.0, ""
    for k, w in grads64.items():
        rms = float(w.square().mean().sqrt())
        lim = GRAD_TOL * w.abs() + GRAD_TOL * rms
        err = (grads[k].double() - w).abs()
        r = float((err / lim).max()) if rms else float(err.max()) * 1e30
        if r > worst:
            worst, name = r, k
    return rel, worst, name


def update_error(params, grads, cfg_opt, p64_before, plant=None) -> float:
    """The AdamW update of the float32 run (under the fault ``plant``,
    when given) against the same update in float64 on the same
    gradients, ``||d32 - d64|| / ||d64||`` over all leaves (``params`` is
    updated in place)."""
    from repro_torch.optim import adamw

    before = {k: v.double() for k, v in params.items()}
    undo = plant() if plant else None
    try:
        adamw.update(grads, adamw.init(params, cfg_opt), params, cfg_opt)
    finally:
        if undo:
            undo()
    p64 = {k: v.clone() for k, v in p64_before.items()}
    s64 = adamw.tree_map(lambda t: t.double() if t.is_floating_point()
                         else t, adamw.init(p64, cfg_opt))
    adamw.update({k: g.double() for k, g in grads.items()}, s64, p64,
                 cfg_opt)
    num = den = 0.0
    for k in params:
        d32 = params[k].double() - before[k]
        d64 = p64[k] - p64_before[k]
        num += float((d32 - d64).square().sum())
        den += float(d64.square().sum())
    return (num / den) ** 0.5


def prefix_left_in():
    """A planted fault of the VLM loss: the prefix rows stay in the loss
    (the last positions dropped instead).  Returns a function that
    undoes it."""
    from repro_torch.models import layers as L
    from repro_torch.models import model

    real = model.loss

    def faulty(params, cfg, batch):
        logits = model.mask_vocab_pad(model.forward(params, cfg, batch), cfg)
        p = batch["prefix_embeds"].shape[1]
        return L.softmax_xent(logits[:, :logits.shape[1] - p],
                              batch["labels"])
    model.loss = faulty
    return lambda: setattr(model, "loss", real)


def block_detached():
    """A planted fault of the forward: the first super-block's output is
    detached (nothing below it gets a gradient).  Returns a function
    that undoes it."""
    from repro_torch.models import transformer as tr

    real, calls = tr._super_block, [0]

    def faulty(x, layers, cfg, positions):
        calls[0] += 1
        out = real(x, layers, cfg, positions)
        return out.detach() if calls[0] == 1 else out
    tr._super_block = faulty
    return lambda: setattr(tr, "_super_block", real)


def bias_correction_dropped():
    """A planted fault of AdamW: no bias correction of the moments.
    Returns a function that undoes it."""
    from repro_torch.optim import adamw

    real = adamw.bias_corrections
    adamw.bias_corrections = lambda step, cfg: (1.0, 1.0)
    return lambda: setattr(adamw, "bias_corrections", real)


def train_grads(torch, dev) -> None:
    """One float32 train step of each of GRAD_ARCHS at published widths
    cut to GRAD_LAYERS layers, held to the same step in float64 run by
    the port's own code on the card: the loss within GRAD_TOL, every
    gradient within rtol GRAD_TOL and atol GRAD_TOL x its RMS, the AdamW
    update within UPDATE_TOL (on the same gradients).  Each limit is
    first shown to catch planted faults: labels left unshifted, one
    block's output detached, the VLM's prefix left in the loss, the bias
    correction dropped."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim import adamw

    for arch in GRAD_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).with_(n_layers=GRAD_LAYERS, dtype="float32")
        cfg64 = cfg.with_(dtype="float64")
        params = model.init_params(cfg, 0, dev)
        p64 = {k: v.double() for k, v in params.items()}
        batch = train_batch(cfg, GRAD_BATCH, GRAD_SEQ, 1, dev)
        loss64, g64 = steps.value_and_grad(p64, cfg64, batch)
        loss, grads = steps.value_and_grad(params, cfg, batch)
        rel, worst, name = grad_error(loss, grads, loss64, g64)
        faults = {"labels unshifted": lambda: steps.value_and_grad(
            params, cfg, dict(batch, labels=batch["tokens"]))}
        plants = [("a block's output detached", block_detached)]
        if cfg.family == "vlm":
            plants.append(("the prefix left in the loss", prefix_left_in))
        for label, plant in plants:
            def run(plant=plant):
                undo = plant()
                try:
                    return steps.value_and_grad(params, cfg, batch)
                finally:
                    undo()
            faults[label] = run
        caught = []
        for label, run in faults.items():
            fl, fg = run()
            frel, fworst, _ = grad_error(fl, fg, loss64, g64)
            if frel <= GRAD_TOL and fworst <= 1:
                fail(f"train[{arch}]: the limits pass {label}")
            caught.append(f"{label}: loss {frel:.3g}, gradient "
                          f"{fworst:.3g}x its limit")
        opt = adamw.AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
        bad = update_error({k: v.clone() for k, v in params.items()},
                           grads, opt, p64, bias_correction_dropped)
        if bad <= UPDATE_TOL:
            fail(f"train[{arch}]: the update limit passes a dropped bias "
                 "correction")
        caught.append(f"bias correction dropped: update {bad:.3g}")
        upd = update_error(params, grads, opt, p64)
        print(f"[train] {arch} at {GRAD_LAYERS} of "
              f"{get_config(arch).n_layers} layers, {GRAD_BATCH} x "
              f"{GRAD_SEQ} tokens"
              + (f" + {cfg.frontend_tokens} zero prefix rows"
                 if cfg.family == "vlm" else "")
              + f": f32 step vs float64: loss {float(loss):.6f} vs "
              f"{float(loss64):.6f} (relative {rel:.3g}, limit {GRAD_TOL}); "
              f"worst gradient {name} at {worst:.3g} of its limit; AdamW "
              f"update {upd:.3g} relative (limit {UPDATE_TOL}); planted "
              f"faults caught: " + "; ".join(caught)
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        if rel > GRAD_TOL or worst > 1 or upd > UPDATE_TOL:
            fail(f"train[{arch}]: the f32 step is not the float64 one")
        del params, p64, grads, g64
        torch.cuda.empty_cache()


def train_restart(torch, dev, where: Path) -> None:
    """At granite-3-2b cut to GRAD_LAYERS layers (bf16): 4 steps
    uninterrupted, against 2 steps, a checkpoint, a restore into fresh
    tensors and 2 more.  The batches bitwise, the restored state bitwise
    what was saved, the losses of steps 3-4 within RESTART_TOL (the
    embedding's backward adds with atomics on the card)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).with_(n_layers=GRAD_LAYERS)
    opt = adamw.AdamWConfig(total_steps=4, warmup_steps=1)
    step = steps.make_train_step(cfg, opt)

    def fresh(seed):
        p = model.init_params(cfg, seed, dev)
        return p, adamw.init(p, opt)

    def pipe(seed=2):
        return TokenPipeline(vocab=cfg.vocab, global_batch=GRAD_BATCH,
                             seq_len=GRAD_SEQ, seed=seed)

    def run(params, state, source, n, batches, losses):
        for _ in range(n):
            b = source.next_batch()
            batches.append(b)
            loss, params, state = step(params, state, b)
            losses.append(float(loss))
        return params, state

    whole_b, whole_l = [], []
    params, state = fresh(0)
    run(params, state, pipe(), 4, whole_b, whole_l)
    del params, state
    part_b, part_l = [], []
    params, state = fresh(0)
    source = pipe()
    params, state = run(params, state, source, 2, part_b, part_l)
    saved = (params, state, source.state_dict())
    ckpt.save(str(where), 2, saved)
    like = fresh(1) + ({"step": 0, "seed": 0},)
    restored = ckpt.restore(str(where), 2, like)
    same = all(type(a) is type(b) and (torch.equal(a, b)
                                       if isinstance(a, torch.Tensor)
                                       else a == b)
               for (_, a), (_, b) in zip(ckpt._leaves(saved),
                                         ckpt._leaves(restored)))
    fresh_tensors = all(a.data_ptr() != b.data_ptr()
                        for (_, a), (_, b) in zip(ckpt._leaves(saved[:2]),
                                                  ckpt._leaves(restored[:2])))
    if not same or not fresh_tensors:
        fail("train restart: the restored state is not what was saved "
             "(or not in fresh tensors)")
    source2 = pipe(99)
    source2.load_state_dict(restored[2])
    run(restored[0], restored[1], source2, 2, part_b, part_l)
    batches_same = all(np.array_equal(a[k], b[k]) for a, b in
                       zip(whole_b, part_b) for k in a)
    rel = max(abs(a - b) / abs(a) for a, b in zip(whole_l[2:], part_l[2:]))
    print(f"[train] restart at {GRAD_LAYERS} layers, {GRAD_BATCH} x "
          f"{GRAD_SEQ}: losses uninterrupted {whole_l}, restored "
          f"{part_l}; batches bitwise equal: {batches_same}; restored "
          f"state bitwise what was saved, in fresh tensors: True; steps "
          f"3-4 relative {rel:.3g} (limit {RESTART_TOL}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if not batches_same or rel > RESTART_TOL:
        fail("train restart: the resumed run is not the uninterrupted one")


def run_train(torch, dev, where: Path) -> None:
    """``[train]``: ``train_full``, ``train_grads``, ``train_restart``."""
    t0 = time.perf_counter()
    train_full(torch, dev)
    t1 = time.perf_counter()
    train_grads(torch, dev)
    t2 = time.perf_counter()
    train_restart(torch, dev, where)
    print(f"[train] phase {time.perf_counter() - t0:.1f} s (full run "
          f"{t1 - t0:.1f} s, float64 checks {t2 - t1:.1f} s, restart "
          f"{time.perf_counter() - t2:.1f} s)", flush=True)


# [dist]: the meshed train step against the plain one, the dry run of it
DIST_STEPS = 3
DIST_TOL = 2e-3              # the f32 rule, where meshed and plain differ
# the production cells the dry run prints: (arch, shape, multi-pod)
DIST_CELLS = (("granite-3-2b", "train_4k", False),
              ("qwen2-72b", "decode_32k", True))
DIST_CELL_TIMEOUT_S = 300


def dist_steps(label: str, step, params, state, batches, torch, dev):
    """Run ``step`` over ``batches`` from ``params`` / ``state``: (losses,
    ms a step on the host clock, synchronized; peak device memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        loss, params, state = step(params, state, batch)
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[dist] {label}: losses {losses}; step ms "
          f"{[round(t, 1) for t in ms]}; peak device memory "
          f"{peak / 1e9:.2f} GB", flush=True)
    return losses, ms, peak


def dist_cells(src: Path) -> None:
    """The production cells of DIST_CELLS, each ``python -m
    repro_torch.launch.dryrun`` in a subprocess (a fake world on the
    host: 256 or 512 ranks, no device), under DIST_CELL_TIMEOUT_S."""
    import os

    env = dict(os.environ, PYTHONPATH=str(src))
    for arch, shape, multi_pod in DIST_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multi-pod"] if multi_pod
                                          else [])
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=DIST_CELL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"dist: the dry run of {arch} {shape} took over "
                 f"{DIST_CELL_TIMEOUT_S} s")
        secs = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            fail(f"dist: the dry run of {arch} {shape} exited "
                 f"{proc.returncode}: {(lines or [''])[-1][:400]} "
                 f"{proc.stderr[-800:]}")
        rec = json.loads(lines[-1])
        print(f"[dist] dry run {arch} {shape} on {rec['mesh']}: "
              f"{secs:.1f} s: {json.dumps(rec)}", flush=True)


def run_dist(torch, dev, where: Path) -> None:
    """``[dist]``: a real NCCL group of one rank (a ``FileStore`` in
    ``where``, no port) and its (1, 1) ("data", "model") CUDA mesh.
    granite-3-2b at full width and depth (bf16, remat, TRAIN_BATCH x
    TRAIN_SEQ) takes DIST_STEPS steps from the same weights and batches
    through the plain step, then through the meshed one: parameters
    placed by ``param_sharding``, optimizer state by
    ``opt_state_sharding``, the batch by ``batch_sharding``,
    ``grad_shardings`` and the hints on.  Losses and every parameter
    after the last step must be bitwise equal, or within DIST_TOL (rtol
    and atol).  The dry run of the same step on this mesh must count
    exactly the bytes of the parameters, optimizer state and batch on
    the card; its temp plus argument bytes are printed beside the meshed
    step's peak memory.  Then the production cells (``dist_cells``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun, shard_rules, steps
    from repro_torch.models.sharding import use_mesh_hints
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    opt = adamw.AdamWConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    batches = [train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed, dev)
               for seed in range(DIST_STEPS)]
    params = make_params("dist", cfg, torch, dev)
    plain_losses, plain_ms, plain_peak = dist_steps(
        "plain step", steps.make_train_step(cfg, opt), params,
        adamw.init(params, opt), batches, torch, dev)
    want = {k: v.cpu() for k, v in params.items()}
    del params
    torch.cuda.empty_cache()

    where.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(where / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))

        def placed(tree, shardings):
            # one rank: each local shard is the whole tensor
            return {k: DTensor.from_local(v, mesh, shardings[k].placements,
                                          run_check=False)
                    for k, v in tree.items()}

        params = make_params("dist", cfg, torch, dev)
        psh = shard_rules.param_sharding(cfg, mesh, params)
        zeros = adamw.init(params, opt)
        osh = shard_rules.opt_state_sharding(
            cfg, mesh, params, adamw.state_specs(params, opt))
        params = placed(params, psh)
        state = adamw.AdamWState(
            DTensor.from_local(zeros.step, mesh, osh.step.placements,
                               run_check=False),
            placed(zeros.m, osh.m), placed(zeros.v, osh.v), None)
        meshed = [placed(b, shard_rules.batch_sharding(mesh, b))
                  for b in batches]
        step = steps.make_train_step(cfg, opt, grad_shardings=psh)
        with use_mesh_hints(mesh):
            losses, ms, peak = dist_steps("meshed step (1x1 mesh)", step,
                                          params, state, meshed, torch, dev)
        same = losses == plain_losses
        worst, diff, n_diff = 0.0, 0.0, 0
        for k, w in want.items():
            got = params[k].to_local()
            w = w.to(dev)
            if not torch.equal(got, w):
                same = False
                n_diff += 1
                d = (got.double() - w.double()).abs()
                diff = max(diff, float(d.max()))
                worst = max(worst, float(
                    (d / (DIST_TOL + DIST_TOL * w.double().abs())).max()))
        loss_err = max(abs(a - b) for a, b in zip(losses, plain_losses))
        print(f"[dist] meshed vs plain after {DIST_STEPS} steps: "
              f"{'bitwise equal' if same else 'not bitwise'}; losses "
              f"{losses} vs {plain_losses} (max abs diff {loss_err:.3g}); "
              f"{n_diff} of {len(want)} parameters differ, max abs diff "
              f"{diff:.3g}, worst over the f32 rule {worst:.3g}; ms a step "
              f"(steps 2..{DIST_STEPS}) meshed "
              f"{[round(t, 1) for t in ms[1:]]} plain "
              f"{[round(t, 1) for t in plain_ms[1:]]}; peak "
              f"{peak / 1e9:.2f} GB meshed, {plain_peak / 1e9:.2f} GB plain",
              flush=True)
        if not same and (worst > 1.0 or any(
                abs(a - b) > DIST_TOL + DIST_TOL * abs(b)
                for a, b in zip(losses, plain_losses))):
            fail("dist: the meshed step is not the plain step within "
                 f"{DIST_TOL}")

        on_card = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in (list(params.values()) + [state.step]
                                + list(state.m.values())
                                + list(state.v.values())
                                + list(meshed[0].values())))
        t0 = time.perf_counter()
        shape = ShapeConfig(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", "train",
                            TRAIN_SEQ, TRAIN_BATCH)
        rec = dryrun.cell_cost(cfg, shape, mesh)
        mem = rec["memory_per_device"]
        predicted = mem["temp_bytes"] + mem["argument_bytes"]
        print(f"[dist] dry run of the same step on the 1x1 mesh "
              f"({time.perf_counter() - t0:.1f} s): argument_bytes "
              f"{mem['argument_bytes']}, on the card {on_card}; temp + "
              f"argument bytes {predicted} ({predicted / 1e9:.2f} GB) vs "
              f"the meshed step's max_memory_allocated {peak} "
              f"({peak / 1e9:.2f} GB): ratio {predicted / peak:.4f}; "
              f"flops {rec['cost_per_device']['flops']:.6g}, collectives "
              f"{ {k: v['count'] for k, v in rec['collectives'].items() if isinstance(v, dict)} }",
              flush=True)
        if mem["argument_bytes"] != on_card:
            fail(f"dist: the dry run counts {mem['argument_bytes']} argument "
                 f"bytes, the card holds {on_card}")
        del params, state, meshed, zeros
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    dist_cells(Path(__file__).resolve().parent / "src")
    print(f"[dist] phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# [examples]: the port's four examples (examples/*_torch.py) on the card
EXAMPLE_LM_STEPS = 200       # train_lm's default --steps
EXAMPLE_TOL = 2e-3           # the f32 rule: quickstart, elastic_restart
SERVE_LM_PROMPT = 16         # serve_lm_torch's prompt length
QUICKSTART_SECTIONS = ("original PPL program",
                       "tiled (strip-mined + interchanged + tile copies)",
                       "main-memory traffic (words)", "metapipeline schedule")


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def text_sections(text: str) -> dict:
    """``{heading: body}`` of an example's ``== heading ==`` sections."""
    out, head = {}, None
    for line in text.splitlines():
        if line.startswith("== ") and line.endswith(" =="):
            head = line[3:-3]
            out[head] = []
        elif head is not None:
            out[head].append(line)
    return {h: "\n".join(b).strip("\n") for h, b in out.items()}


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name`` set to ``value`` for the block, put back after."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def example_quickstart(cc, tier, torch, dev) -> dict:
    """``quickstart_torch`` on the card: one ``tiled_gemm`` launch (128^3,
    tiles 64^3, depth 2), its output against the template's plain version
    and the numpy reference at the f32 rule after proving that limit
    catches a dropped K slab, its IR, traffic and schedule text equal to
    its CPU run's character for character; timed beside its plain
    version and ``torch.matmul``."""
    ex = load_example("quickstart_torch")
    cpu_text = ex.main(["--device", "cpu"])
    torch.cuda.synchronize()
    cc.tiled_gemm.launches = 0
    stats = {}
    text = ex.main(["--device", "cuda"], stats)
    torch.cuda.synchronize()
    launches = cc.tiled_gemm.launches
    if launches != 1:
        fail(f"examples: quickstart launched tiled_gemm {launches} times, "
             "not once")
    got, want = text_sections(text), text_sections(cpu_text)
    for head in QUICKSTART_SECTIONS:
        if got.get(head) != want.get(head):
            fail(f"examples: quickstart's '{head}' differs from its CPU run")
    from repro_torch.patterns.analytics import gemm

    _, _, make_inputs, _ = gemm(m=128, n=128, k=128, bm=64, bn=64, bk=64)
    host = make_inputs()
    x = torch.as_tensor(host["x"]).to(dev)
    y = torch.as_tensor(host["y"]).to(dev)
    out = torch.as_tensor(stats["kernel"]).to(dev)
    e_plain = max_err(out, cc.tiled_gemm_plain(x, y, bm=64, bn=64, bk=64),
                      torch, "quickstart vs plain", EXAMPLE_TOL)
    e_ref = max_err(out, stats["reference"], torch,
                    "quickstart vs numpy", EXAMPLE_TOL)
    want64 = torch.as_tensor(host["x"].astype("float64")
                             @ host["y"].astype("float64"), device=dev)
    faults = gemm_faults(x, y, want64, 64, 2, torch)
    print(f"[examples] quickstart: tiled_gemm launches={launches}; max abs "
          f"err vs plain {e_plain:.3e}, vs numpy {e_ref:.3e} (rtol/atol "
          f"{EXAMPLE_TOL}/{EXAMPLE_TOL}); planted faults caught: "
          + "; ".join(faults) + "; IR, traffic and schedule text equal to "
          "the CPU run's", flush=True)

    def run():
        return cc.tiled_gemm(x, y, bm=64, bn=64, bk=64, depth=2)
    ms = median_ms(run, torch)
    plain_ms = median_ms(
        lambda: cc.tiled_gemm_plain(x, y, bm=64, bn=64, bk=64), torch)
    lib_ms = median_ms(lambda: torch.matmul(x, y), torch)
    flops = 2 * 128 ** 3
    bound_ms, by = bound(nbytes_of(x, y, out), flops, tier)
    print(f"[examples] quickstart tiled_gemm {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({by})", flush=True)
    return {"name": "tiled_gemm[quickstart,128^3,64x64x64,d2]",
            "route": "cuda", "source": f"{CSRC}/tiled_gemm.cuh",
            "replaces": GEMM_TPU, "launches": launches,
            "max_abs_err": e_plain, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


def host_weights(model):
    """``model.init_params`` drawing on the host and copying to the asked
    device: the CPU and the card start from the same weights (a CUDA
    generator draws other numbers than the CPU's at the same seed)."""
    real = model.init_params

    def init(cfg, seed=0, device=None):
        return {k: v.to(device) for k, v in real(cfg, seed, "cpu").items()}
    return init


def serve_lm_runs(ex, dtype: str, torch, dev, plant: bool = False) -> tuple:
    """``serve_lm_torch`` in ``dtype`` (the SMOKE configs switched) on the
    CPU and on the card from the same host-drawn weights; with ``plant``
    the card's run carries two planted faults (the last layer's K/V
    write skipped, the conv state dropped).  Returns (cpu stats, card
    stats)."""
    import repro_torch.configs as configs
    from repro_torch.models import model

    with contextlib.ExitStack() as stack:
        for arch in ex.ARCHS:
            mod = configs.ARCHS[arch]
            stack.enter_context(patched(mod, "SMOKE",
                                        mod.SMOKE.with_(dtype=dtype)))
        stack.enter_context(patched(model, "init_params", host_weights(model)))
        cpu = {}
        ex.main(["--device", "cpu"], cpu)
        undo = [last_cache_write_skipped(), conv_state_dropped()] \
            if plant else []
        card = {}
        try:
            ex.main(["--device", "cuda"], card)
        finally:
            for u in undo:
                u()
        torch.cuda.synchronize()
    return cpu, card


def serve_lm_misses(arch: str, cpu: dict, card: dict, dtype: str,
                    torch) -> list:
    """Where the card's tokens fail the rule: float32 identical to the
    CPU's; bfloat16 each token one the CPU model scores, teacher-forced
    on the card's tokens, within the bf16 tolerance of its best
    (``serve.near_best``).  Returns the misses (empty: held)."""
    a, b = card[arch]["tokens"], cpu[arch]["tokens"]
    first_a, first_b = card[arch]["first_tokens"], cpu[arch]["first_tokens"]
    if np.array_equal(a, b) and np.array_equal(first_a, first_b):
        return []
    if dtype == "float32":
        return [f"{arch}: tokens {a.tolist()} != the CPU's {b.tolist()}"]
    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = get_config(arch, smoke=True)
    params = model.init_params(cfg, 0, "cpu")
    lens = [SERVE_LM_PROMPT] * a.shape[0]
    rows = family_oracle(cfg, params, lens, a, first_a, torch,
                         torch.device("cpu"))
    misses, _ = family_misses(rows, a, first_a, dtype)
    return [f"{arch}: {m[1]}" for m in misses if m is not None]


def example_serve(torch, dev) -> dict:
    """``serve_lm_torch`` on the card against its CPU run from the same
    weights: float32 tokens identical, bfloat16 by the near-best rule;
    each rule first shown to reject a card run with planted faults.
    Returns each arch's card ms a token (bfloat16)."""
    ex = load_example("serve_lm_torch")
    per_token = {}
    for dtype in ("float32", "bfloat16"):
        cpu, faulty = serve_lm_runs(ex, dtype, torch, dev, plant=True)
        for arch in ex.ARCHS:
            if not serve_lm_misses(arch, cpu, faulty, dtype, torch):
                fail(f"examples: serve_lm's {dtype} rule does not reject "
                     f"{arch} served with the planted faults")
        cpu, card = serve_lm_runs(ex, dtype, torch, dev)
        misses = [m for arch in ex.ARCHS
                  for m in serve_lm_misses(arch, cpu, card, dtype, torch)]
        if misses:
            fail(f"examples: serve_lm {dtype}: " + "; ".join(misses))
        same = all(np.array_equal(card[a]["tokens"], cpu[a]["tokens"])
                   for a in ex.ARCHS)
        print(f"[examples] serve_lm {dtype}: every arch's tokens held to "
              f"its CPU run (identical: {same}; the planted faults "
              "rejected for all three first); card ms a token "
              + ", ".join(f"{a} {card[a]['ms_per_token']:.3f}"
                          for a in ex.ARCHS), flush=True)
        if dtype == "bfloat16":
            per_token = {a: card[a]["ms_per_token"] for a in ex.ARCHS}
    return per_token


def norm_scale_dropped():
    """A planted fault of the forward: every RMS norm scales by its
    weight without dividing by the root mean square.  Returns a function
    that undoes it."""
    from repro_torch.models import layers

    real = layers.rms_norm
    layers.rms_norm = lambda x, w, eps=1e-6: \
        (x * (1.0 + w.to(x.dtype))).to(x.dtype)
    return lambda: setattr(layers, "rms_norm", real)


def example_train(torch, dev, where: Path) -> None:
    """``train_lm_torch`` at LM_130M, batch 8 x 256, its default 200
    steps on the card: losses finite, the last below the first by more
    than the bf16 tolerance (a run whose updates are dropped must fail
    that: the first weights' loss on the last batch); the first three
    within the bf16 tolerance of the same three steps run on the CPU from
    the same weights (a forward with every norm's scaling dropped must
    fail that).  ms a step, tokens a second, peak memory, the
    checkpoint writes' seconds."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.serve import TOLERANCES
    from repro_torch.models import model
    from repro_torch.optim import adamw

    ex = load_example("train_lm_torch")
    cfg = ex.LM_130M
    rtol, atol = TOLERANCES[cfg.dtype]
    rows, seq = 8, 256
    t0 = time.perf_counter()
    # what train draws on the card (seed 0), and the batches it feeds
    p0 = model.init_params(cfg, 0, dev)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=rows, seq_len=seq,
                         seed=0)
    first = train_mod._batch(pipe, cfg, dev)
    pipe.step = EXAMPLE_LM_STEPS - 1
    last = train_mod._batch(pipe, cfg, dev)
    with torch.no_grad():
        frozen = float(model.loss(p0, cfg, last))
        undo = norm_scale_dropped()
        try:
            unnormed = float(model.loss(p0, cfg, first))
        finally:
            undo()
    opt = adamw.AdamWConfig(total_steps=EXAMPLE_LM_STEPS,
                            warmup_steps=max(1, EXAMPLE_LM_STEPS // 10))
    step = steps.make_train_step(cfg, opt)
    params = {k: v.cpu() for k, v in p0.items()}
    del p0
    state = adamw.init(params, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=rows, seq_len=seq,
                         seed=0)
    cpu_losses = []
    for _ in range(3):
        loss, params, state = step(params, state, train_mod._batch(
            pipe, cfg, torch.device("cpu")))
        cpu_losses.append(float(loss))
    del params, state
    cpu_s = time.perf_counter() - t0

    writes, copies = [], []

    def timed(fn, into):
        def run(*a, **k):
            ts = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                into.append(time.perf_counter() - ts)
        return run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    t1 = time.perf_counter()
    with patched(ckpt, "_save_host", timed(ckpt._save_host, writes)), \
            patched(ckpt, "_flatten", timed(ckpt._flatten, copies)):
        ex.main(["--steps", str(EXAMPLE_LM_STEPS), "--ckpt-dir",
                 str(where / "train_lm"), "--device", "cuda"], stats)
    run_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated(dev)
    losses = stats["losses"]
    if stats["start"] != 0 or len(losses) != EXAMPLE_LM_STEPS \
            or not all(np.isfinite(losses)):
        fail(f"examples: train_lm ran from step {stats['start']}: losses "
             f"{losses}")

    def fell(a, b):
        return b < a - (atol + rtol * abs(a))
    if fell(losses[0], frozen):
        fail(f"examples: train_lm's falling-loss rule would pass a run "
             f"whose updates are dropped ({losses[0]} -> {frozen})")
    if not fell(losses[0], losses[-1]):
        fail(f"examples: train_lm's loss did not fall: {losses[0]} -> "
             f"{losses[-1]}")

    def held(a, b):
        return abs(a - b) <= atol + rtol * abs(b)
    if held(unnormed, cpu_losses[0]):
        fail(f"examples: train_lm's {cfg.dtype} rule would pass a forward "
             f"with the norms' scaling dropped ({unnormed} vs "
             f"{cpu_losses[0]})")
    if not all(held(a, b) for a, b in zip(losses[:3], cpu_losses)):
        fail(f"examples: train_lm's first losses {losses[:3]} are not "
             f"within {cfg.dtype}'s rtol/atol {rtol}/{atol} of the CPU run's "
             f"{cpu_losses}")
    step_ms = sorted(t * 1e3 for t in stats["step_s"][1:])
    med = step_ms[len(step_ms) // 2]
    if len(writes) != EXAMPLE_LM_STEPS // 50:
        fail(f"examples: train_lm wrote {len(writes)} checkpoints")
    print(f"[examples] train_lm: LM_130M ({cfg.param_count()} parameters, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}), "
          f"{EXAMPLE_LM_STEPS} steps of {rows} x {seq} tokens: loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f} (the first weights on the "
          f"last batch: {frozen:.6f}); first three {losses[:3]} vs the "
          f"CPU's {cpu_losses} (rtol/atol {rtol}/{atol}; norms' scaling "
          f"dropped: {unnormed:.6f}); median step {med:.2f} ms (steps "
          f"2..{EXAMPLE_LM_STEPS}), {rows * seq / med * 1e3:.0f} tokens/s; "
          f"peak device memory {peak / 1e9:.3f} GB "
          f"(torch.cuda.max_memory_allocated); {len(writes)} checkpoint "
          f"writes {[round(w, 3) for w in writes]} s on the writer thread, "
          f"host copies {[round(c, 3) for c in copies]} s; run "
          f"{run_s:.1f} s, CPU steps {cpu_s:.1f} s", flush=True)


def example_elastic(torch, dev, where: Path) -> None:
    """``elastic_restart_torch`` on the card: phase 5 resumes at step 10,
    its losses for steps 10-13 within EXAMPLE_TOL of an uninterrupted
    14-step run on the card (bitwise equality reported), a limit first
    shown to reject a resume from step 5's checkpoint relabelled as step
    10."""
    import shutil

    from repro_torch.launch.train import train

    ex = load_example("elastic_restart_torch")
    stats = {}
    ex.main(["--device", "cuda"], stats)
    if stats["start_5"] != 10 or len(stats["losses_5"]) != 4:
        fail(f"examples: elastic_restart's phase 5 resumed at step "
             f"{stats['start_5']} and ran {len(stats['losses_5'])} steps")
    d = where / "elastic"
    kw = dict(smoke=True, batch=2, seq=32, ckpt_every=5, log_every=100,
              device=dev)
    whole, _ = train("granite-3-2b", n_steps=14, ckpt_dir=str(d), **kw)
    shutil.rmtree(d / "step-10")
    (d / "step-5").rename(d / "step-10")
    relabelled, _ = train("granite-3-2b", n_steps=14, ckpt_dir=str(d), **kw)

    def held(got):
        return np.allclose(got, whole[10:], rtol=EXAMPLE_TOL,
                           atol=EXAMPLE_TOL)
    if held(relabelled):
        fail("examples: elastic_restart's rule would pass a resume from "
             f"step 5's checkpoint relabelled as step 10 ({relabelled} vs "
             f"{whole[10:]})")
    if not held(stats["losses_5"]):
        fail(f"examples: elastic_restart resumed {stats['losses_5']}, the "
             f"uninterrupted run {whole[10:]}")
    print(f"[examples] elastic_restart: phase 5 resumed at step 10: losses "
          f"{stats['losses_5']}, uninterrupted {whole[10:]} (rtol/atol "
          f"{EXAMPLE_TOL}/{EXAMPLE_TOL}; bitwise equal: "
          f"{stats['losses_5'] == whole[10:]}); step 5's checkpoint "
          f"relabelled as 10 rejected: {relabelled}", flush=True)


def run_examples(cc, tier, torch, dev, where: Path) -> dict:
    """``[examples]``: the port's four examples on the card, each held to
    its CPU run or to an uninterrupted run; returns quickstart's kernel
    row."""
    t0 = time.perf_counter()
    row = example_quickstart(cc, tier, torch, dev)
    t1 = time.perf_counter()
    per_token = example_serve(torch, dev)
    t2 = time.perf_counter()
    example_train(torch, dev, where)
    t3 = time.perf_counter()
    example_elastic(torch, dev, where)
    print(f"[examples] phase {time.perf_counter() - t0:.1f} s (quickstart "
          f"{t1 - t0:.1f} s, serve_lm {t2 - t1:.1f} s, train_lm "
          f"{t3 - t2:.1f} s, elastic_restart "
          f"{time.perf_counter() - t3:.1f} s); serve_lm bf16 ms a token "
          f"{per_token}", flush=True)
    return row


TUNING_PROGRAMS = ("outerprod", "gda", "gemm", "filter")


def _modeled(kind_of: str, program, tier, dse, calibrate, kind: str) -> dict:
    """Each shortlisted candidate's modeled seconds, priced as the
    measured DSE is about to price it (the device's current calibration
    profile): ``{candidate: seconds}`` in analytic order."""
    prof = calibrate.load_profile(kind)
    if kind_of == "pipeline":
        priced = dse._price_whole_pipeline(
            program, vmem_budget=tier.onchip_bytes, tier=tier,
            counters={"explored": 0, "pruned": 0}, profile=prof)
        return {(b, d): res[3] for (b, d), res in priced[:dse.TOP_K]}
    cands, _, _, _ = dse.shortlist(program, tier=tier,
                                   vmem_budget=tier.onchip_bytes,
                                   profile=prof,
                                   kernel=dse.template_kernel(program, tier))
    return {tuple(sorted((k, tuple(v)) for k, v in c.sizes.items())):
            c.calibrated_seconds
            for c in dse._top_distinct_sizes(cands, dse.TOP_K)}


def _cand(entry) -> tuple:
    """A measured-rank or certification entry's candidate identity."""
    if "sizes" in entry:
        return tuple(sorted((k, tuple(v)) for k, v in entry["sizes"].items()))
    return (entry["block"], entry["depth"])


def planted_tile_fault(p, dev, cc, dse, resilience) -> None:
    """Certification on the card passes the DSE's outer-product plan and
    refuses the same candidate with its first output tile zeroed."""
    plan = dse.explore(p, device=dev)
    ok, why = resilience.certify_tile_plan(p, plan.sizes, device=dev,
                                           depth=plan.depth)
    if not ok:
        fail(f"tuning: certification refused the outer product's plan "
             f"{plan.sizes}: {why}")
    real = cc.lower_for_timing

    def dropped(q, sizes, **kw):
        fn, how = real(q, sizes, **kw)
        bm, bn = sizes["outer"]

        def run():
            out = fn().clone()
            out[:bm, :bn] = 0
            return out

        return run, how

    cc.lower_for_timing = dropped
    try:
        bad, bad_why = resilience.certify_tile_plan(
            p, plan.sizes, device=dev, depth=plan.depth)
    finally:
        cc.lower_for_timing = real
    if bad:
        fail("tuning: certification passed a candidate whose first "
             "tile is zero")
    print(f"[tuning] certification on the card: plan {plan.sizes} "
          f"certified ({why}); with its first tile dropped refused "
          f"({bad_why})", flush=True)


def run_tuning(tier, torch, dev, stores: Path) -> None:
    """The measured DSE on the card, tracing on, its stores in a fresh
    ``stores``: ``explore_pipeline(pipe, measure="top_k")`` for the five
    pipelines and ``explore(p, measure="top_k")`` for outerprod, gda and
    gemm of SUITE and the Table 2 filter, at the main path's sizes (the
    GEMM in the tiled-GEMM template's own space, ``dse.template_kernel``,
    as ``lower_auto`` explores it).
    Prints each program's analytic and measured winners, every
    candidate's modeled and measured ms, Spearman's rho and the build
    seconds; checks every measured winner certified, a second call a
    cache hit with zero builds and lowerings, no event but
    ``lower-unsupported``, a calibration profile keyed to the card, and
    a trace ``benchmarks/check_trace.py`` accepts."""
    import os

    from repro_torch.core import calibrate, dse, measure, resilience
    from repro_torch.core import codegen_cuda as cc
    from repro_torch.core import telemetry
    from repro_torch.kernels import build
    from repro_torch.patterns.analytics import PIPELINES, SUITE

    stores.mkdir(parents=True, exist_ok=True)
    saved = {v: os.environ.pop(v, None) for v in (
        "REPRO_DSE_CACHE", "REPRO_TIMING_DB", "REPRO_CALIB_PROFILE",
        "REPRO_MEASURE", "REPRO_FAULTS", "REPRO_TRACE")}
    os.environ["REPRO_DSE_CACHE"] = str(stores / "dse_cache.json")
    telemetry.reset()
    telemetry.enable()
    t_phase = time.perf_counter()
    kind = measure.device_kind(dev)
    try:
        planted_tile_fault(SUITE["outerprod"](OUTER_N, OUTER_N)[0], dev, cc,
                           dse, resilience)
        resilience.LOG.reset()
        programs = [(f"pipeline[{n}]", "pipeline",
                     b(n=TPCH_ROWS if n == "tpchq6" else ROWS)[0])
                    for n, b in PIPELINES.items()]
        shapes = {"outerprod": (OUTER_N, OUTER_N), "gemm": (GEMM_N,) * 3}
        for n in TUNING_PROGRAMS:
            p = filter_program(TPCH_ROWS)[0] if n == "filter" else \
                SUITE[n](*shapes[n])[0] if n in shapes else \
                SUITE[n](n=ROWS)[0]
            programs.append((n, "pattern", p))
        launches = {"tiled_map": cc.tiled_map, "fused_dag": cc.fused_dag,
                    "tiled_flatmap": cc.tiled_flatmap,
                    "tiled_gemm": cc.tiled_gemm}
        for fn in launches.values():
            fn.launches = 0
        for label, kind_of, p in programs:
            modeled = _modeled(kind_of, p, tier, dse, calibrate, kind)
            # a program whose template has its own space (the GEMM's) is
            # explored in it, as lower_auto explores it
            explore = dse.explore_pipeline if kind_of == "pipeline" \
                else functools.partial(dse.explore,
                                       kernel=dse.template_kernel(p, tier))
            b0 = build.compile_all.builds
            s0 = telemetry.metrics_snapshot()["counters"].get(
                "dse.build_s", 0.0)
            t0 = time.perf_counter()
            plan = explore(p, measure="top_k", device=dev)
            secs = time.perf_counter() - t0
            build_s = telemetry.metrics_snapshot()["counters"].get(
                "dse.build_s", 0.0) - s0
            rec = dse.explain_dict(plan)["provenance"]
            timed = {_cand(r): r["median_s"] for r in rec["measured_ranks"]}
            first = next(iter(modeled))
            if kind_of == "pattern":
                first, won = dict(first), plan.sizes
            else:
                won = (plan.block, plan.depth)
            print(f"[tuning] {label}: analytic winner {first}, measured "
                  f"winner {won} (measured={plan.measured}, timed "
                  f"{plan.timed}); "
                  f"{build.compile_all.builds - b0} nvcc builds in "
                  f"{build_s:.1f} s; {secs:.1f} s in all", flush=True)
            for cand, s in modeled.items():
                got = timed.get(cand)
                print(f"[tuning]   {cand}: modeled {s * 1e3:.6g} ms, "
                      + (f"measured {got * 1e3:.6g} ms" if got is not None
                         else "not timed (no template)"))
            pairs = [(modeled[c], timed[c]) for c in modeled if c in timed]
            if len(pairs) >= 2:
                rho = measure.spearman([a for a, _ in pairs],
                                       [b for _, b in pairs])
                print(f"[tuning]   spearman rho (modeled vs measured, "
                      f"{len(pairs)} candidates) = {rho:.3f}")
            if not plan.measured:
                fail(f"tuning: {label} shipped no measured winner")
            win = [c for c in rec["certification"] if c["ok"]]
            if not win:
                fail(f"tuning: {label}'s measured winner has no "
                     "certificate")
            print(f"[tuning]   winner certified on the card: "
                  f"{win[-1]['reason']}")
            b1, n_spans = build.compile_all.builds, len(telemetry.span_log())
            again = explore(p, measure="top_k", device=dev)
            lowered = [s["name"] for s in telemetry.span_log()[n_spans:]
                       if s["name"].startswith("codegen.")]
            if not again.cached or build.compile_all.builds != b1 or lowered:
                fail(f"tuning: {label}'s second call was not a pure cache "
                     f"hit (cached={again.cached}, builds "
                     f"{build.compile_all.builds - b1}, lowered {lowered})")
            print(f"[tuning]   second call: cache hit, 0 builds, 0 "
                  "lowerings")
        counts = {k: fn.launches for k, fn in launches.items()}
        print(f"[tuning] launches on the path: {counts}")
        for k in ("tiled_map", "fused_dag", "tiled_flatmap"):
            if counts[k] == 0:
                fail(f"tuning: {k} was never launched")
        others = [(e.stage, e.kind, e.action) for e in resilience.LOG.events()
                  if e.kind != "lower-unsupported"]
        if others:
            fail(f"tuning: events other than lower-unsupported: {others}")
        print(f"[tuning] event log: {len(resilience.LOG.events())} events,"
              " all lower-unsupported")
        prof = calibrate.load_profile(kind)
        path = Path(calibrate.profile_path(kind))
        if prof is None or prof.device != kind or kind not in path.name:
            fail(f"tuning: no calibration profile keyed to {kind}")
        print(f"[tuning] calibration profile {path.name}: {prof.mode}, "
              f"{prof.n_samples} samples, effective "
              f"{prof.bandwidth_bytes_per_s / 1e12:.3f} TB/s, overhead "
              f"{ {k: round(v * 1e6, 3) for k, v in prof.overhead_s.items()} }"
              " us a step")
        trace = telemetry.export_trace(str(stores / "trace.json"))
        checked = subprocess.run(
            [sys.executable, str(Path(__file__).resolve().parent
                                 / "benchmarks" / "check_trace.py"), trace],
            capture_output=True, text=True)
        if checked.returncode != 0:
            fail(f"tuning: check_trace.py refused the trace: "
                 f"{checked.stdout}{checked.stderr}")
        print(f"[tuning] trace {trace}: "
              f"{len(telemetry.span_log())} spans, check_trace.py ok")
        print(f"[tuning] phase {time.perf_counter() - t_phase:.1f} s",
              flush=True)
    finally:
        telemetry.reset()
        for var, val in saved.items():
            os.environ.pop(var, None)
            if val is not None:
                os.environ[var] = val


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # the DSE's stores (tuning cache, timing DB, calibration profile) in
    # a fresh directory of this run under the git-ignored build/
    import os
    stores = src.parent / "build" / "chip_smoke" / \
        f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
    for var in ("REPRO_TIMING_DB", "REPRO_CALIB_PROFILE", "REPRO_MEASURE",
                "REPRO_FAULTS", "REPRO_TRACE"):
        os.environ.pop(var, None)
    os.environ["REPRO_DSE_CACHE"] = str(stores / "main" / "dse_cache.json")

    from repro_torch.core import codegen_cuda as cc
    from repro_torch.core import pipeline as plmod
    from repro_torch.core.cost import device_tier
    from repro_torch.core.strip_mine import tile
    from repro_torch.kernels import build
    from repro_torch.kernels import filter_reduce as fr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.patterns.analytics import PIPELINES, gda, gemm, outerprod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    tier = device_tier(dev)
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs"
          f" | tier {tier}", flush=True)
    if sys.argv[1:] == ["--tuning"]:    # the measured-DSE phase alone
        run_tuning(tier, torch, dev, stores / "tuning")
        return 0
    if sys.argv[1:] == ["--dist"]:      # the distribution phase alone
        run_dist(torch, dev, stores / "dist")
        return 0
    if sys.argv[1:] == ["--examples"]:  # the port's examples alone
        run_examples(cc, tier, torch, dev, stores / "examples")
        return 0
    if sys.argv[1:] == ["--kmeans"]:    # the nearest-row DAG alone
        print(json.dumps({"kernels": run_nearest(cc, tier, torch, dev)}))
        return 0
    if sys.argv[1:] == ["--models"]:    # the audio, VLM and train phases
        run_media("audio", "musicgen-medium", tier, torch, dev)
        run_media("vlm", "internvl2-1b", tier, torch, dev)
        run_train(torch, dev, stores / "train")
        return 0

    # ---- lower every pipeline (kernels build lazily), then build all
    t0 = time.perf_counter()
    sizes = {name: (TPCH_ROWS if name == "tpchq6" else ROWS)
             for name in PIPELINES}
    built = {}
    sources, labels = [], []
    for name, builder in PIPELINES.items():
        pipe, make_inputs, reference = builder(n=sizes[name])
        call = plmod.lower_pipeline(pipe)
        for g in call.group_calls:
            sources.append((g.kernel.name, g.kernel.source))
            labels.append(f"fused_dag[{name}]")
        built[name] = (builder, pipe, make_inputs, reference, call)
    # the GEMM template at the analytics default tile and depth 2, and at
    # 128x128x32 (a tile that suits the FFMA design) at depth 3
    gemm_calls = {}
    for gtile, depth in (((64, 64, 64), 2), ((128, 128, 32), 3)):
        gp, gsizes, g_inputs, _ = gemm(GEMM_N, GEMM_N, GEMM_N, *gtile)
        label = "tiled_gemm[{}x{}x{},d{}]".format(*gtile, depth)
        gemm_calls[label] = (cc.lower(tile(gp, gsizes), depth=depth), gtile,
                             depth)
        sources.append(("tiled_gemm", gemm_calls[label][0].source))
        labels.append(label)
    # the compiler's own GEMM: lower_auto plans it in the template's space
    gemm_auto = cc.lower_auto(gemm(GEMM_N, GEMM_N, GEMM_N)[0])
    sources.append(("tiled_gemm", gemm_auto.source))
    labels.append("lower_auto[gemm]")
    # single patterns: the DSE on the card's budget picks each plan
    singles = {"outerprod": outerprod(OUTER_N, OUTER_N),
               "gda": gda(n=ROWS), "filter": filter_program(TPCH_ROWS)}
    autos = {}
    for name, (p, _, make_inputs, reference) in singles.items():
        call = cc.lower_auto(p)
        plan = call.tile_plan
        print(f"[{name}] lower_auto plan: sizes={plan.sizes} depths="
              f"{plan.depths} onchip_bytes={plan.vmem_bytes}", flush=True)
        sources.append((call.kernel.name, call.kernel.source))
        labels.append(f"lower_auto[{name}]")
        autos[name] = (call, make_inputs, reference)
    # the hand-written kernels: one fixed translation unit each
    for lib in (mm.LIB, fr.LIB, fa.LIB, ssd.LIB, cc.PAGED_DECODE_LIB):
        sources.append((lib.name, lib.source))
        labels.append(lib.name)
    # the keyed kernels: one translation unit per table, plan and form
    for label, lib in keyed_libraries(dev, torch):
        sources.append((lib.name, lib.source))
        labels.append(label)
    paths = build.compile_all(sources)
    print(f"build: {len(paths)} translation units in "
          f"{time.perf_counter() - t0:.1f} s (plans included)", flush=True)
    for label, p in zip(labels, paths):
        log = p.with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {label}: {line.strip()}")
        stacks = [int(b) for b in re.findall(r"(\d+) bytes stack frame", log)]
        if (is_dag(label) or is_keyed(label) or label in NO_STACK) \
                and any(stacks):
            fail(f"ptxas: {label} has a stack frame ({max(stacks)} bytes)")
    sass_check({lib: p for lib, p in zip(labels, paths)
                if lib in SASS_VARIANTS or lib.startswith("tiled_gemm")
                or lib == "lower_auto[gemm]" or is_dag(lib) or is_keyed(lib)})

    kernels = []

    # ---- the five pipelines through the fused megakernel
    for name, (builder, pipe, make_inputs, reference, call) in built.items():
        host = make_inputs()
        inputs = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
        torch.cuda.synchronize()
        cc.fused_dag.launches = 0
        out = call(**inputs)
        torch.cuda.synchronize()
        launches = cc.fused_dag.launches
        plan = call.pipeline_plan
        print(f"[{name}] n={pipe.shared_extent} plan: block={plan.block} "
              f"groups={list(plan.groups)} group_blocks="
              f"{list(plan.group_blocks)} depths={list(plan.depths)} "
              f"onchip_bytes={plan.vmem_bytes}", flush=True)
        print(f"[{name}] group_lowerings={list(call.group_lowerings)} "
              f"fused_dag launches={launches}")
        if any(how != "megakernel" for _, how in call.group_lowerings):
            fail(f"{name}: a group did not lower to the megakernel")
        if launches < len(plan.groups):
            fail(f"{name}: fused_dag launched {launches} times for "
                 f"{len(plan.groups)} groups")
        for g in call.group_calls:
            dag_forms(name, g.kernel.spec)
        names = plmod.output_names(pipe)
        outs = as_outputs(out, names)
        same_bits(name, outs, as_outputs(call(**inputs), names), torch)
        plain = dict(inputs)
        for g in call.group_calls:
            plain.update(cc.fused_dag_plain(g.kernel.spec, plain))
        ref = as_outputs(reference(host), names)
        if set(ref) != set(outs):
            fail(f"{name}: outputs {sorted(outs)} != {sorted(ref)}")
        group = call.group_calls[0]
        spec = group.kernel.spec
        kinds = {t.name: t.kind for g in call.group_calls
                 for t in g.kernel.spec.terminals}
        shifts = None
        if any(kinds[k] != "map" for k in outs):
            shifts = fault_shifts(lambda rows, b=builder: b(n=rows)[2],
                                  host, pipe.shared_extent,
                                  spec.block, spec.grid,
                                  group.kernel.ctas(dev), names)
        e_plain = 0.0
        for k in outs:
            if kinds[k] == "map":
                ep = max_err(outs[k], plain[k], torch, f"{name}/{k} vs plain")
                er = max_err(outs[k], ref[k], torch,
                             f"{name}/{k} vs reference")
                how = f"rtol/atol {RTOL}/{ATOL}"
            else:
                ep, er, limit = check_sum(k, outs[k], plain[k], ref[k],
                                          shifts, torch, f"{name}/{k}")
                how = (f"limit {limit:.6g}; planted faults shift it by "
                       + ", ".join(f"{by[k]:.6g} ({f})"
                                   for f, by in shifts.items()))
            e_plain = max(e_plain, ep)
            print(f"[{name}] {k} ({kinds[k]}): max abs err vs plain "
                  f"{ep:.6g}, vs reference {er:.6g}; {how}")

        env = dict(inputs)
        ms = median_ms(lambda: cc.fused_dag(group.kernel, env), torch)
        plain_ms = median_ms(
            lambda: cc.fused_dag_plain(group.kernel.spec, env), torch)
        nbytes = sum(t.numel() * t.element_size() for t in inputs.values()) \
            + sum(t.numel() * t.element_size() for t in outs.values())
        bound_ms, by = bound(nbytes, pipeline_ops(name, host), tier)
        print(f"[{name}] fused_dag {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({nbytes} B, "
              f"{pipeline_ops(name, host)} ops)", flush=True)
        dag_breakdown(name, lambda: cc.fused_dag(group.kernel, env),
                      group.kernel.spec, torch)
        kernels.append({
            "name": f"fused_dag[{name}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_dag.cuh",
            "replaces": f"{REPLACES}:564", "launches": launches,
            "max_abs_err": e_plain, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None})
        del inputs, out, outs, plain, env, ref

    # ---- the tiled GEMM template at two tiles
    host = g_inputs()
    x = torch.as_tensor(host["x"]).to(dev)
    y = torch.as_tensor(host["y"]).to(dev)
    for label, (call, gtile, depth) in gemm_calls.items():
        kernels.append(run_tiled_gemm(label, call, x, y, host, gtile, depth,
                                      cc, tier, torch))
    kernels.append(run_auto_gemm(gemm_auto, x, y, host, cc, tier, torch))
    del x, y, host

    kernels.append(run_outerprod(*autos["outerprod"], cc, tier, torch))
    kernels.append(run_gda(*autos["gda"], cc, tier, torch, dev))
    kernels.append(run_filter(*autos["filter"], cc, tier, torch, dev))
    kmeans_call = built["kmeans"][4]
    kernels.extend(run_hand_kernels(kmeans_call.group_calls[0].kernel, cc,
                                    tier, torch, dev))
    kernels.extend(run_nearest(cc, tier, torch, dev))
    kernels.extend(run_lm_kernels(tier, torch, dev))
    kernels.extend(run_paged_kernels(tier, torch, dev))
    kernels.append(run_serving(tier, torch, dev))
    kernels.extend(run_moe(tier, torch, dev))
    run_buckets(torch, dev)
    run_family("ssm", "mamba2-370m", tier, torch, dev)
    run_family("hybrid", "zamba2-2.7b", tier, torch, dev)
    run_media("audio", "musicgen-medium", tier, torch, dev)
    run_media("vlm", "internvl2-1b", tier, torch, dev)
    run_train(torch, dev, stores / "train")
    run_dist(torch, dev, stores / "dist")
    kernels.append(run_examples(cc, tier, torch, dev, stores / "examples"))
    run_tuning(tier, torch, dev, stores / "tuning")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
