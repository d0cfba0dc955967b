"""Pipeline fusion: lower multi-pattern programs as one CUDA megakernel.

The paper's programming model composes whole patterns into pipelines
(tpchq6 = filter -> fold, gda = map -> keyed fold, kmeans = assign ->
scatter); its perf claims (Fig. 5/6, the metapipeline overlap of §5)
assume those stages are *vertically fused* so intermediates stay
on-chip.  Instead of one kernel per pattern with every intermediate
round-tripping main memory, a :class:`Pipeline` lowers as a single
megakernel in which producer tiles land in shared-memory scratch
(``depth``-slot rotating buffers per the metapipeline schedule) and are
consumed in place -- only pipeline inputs and the final outputs touch
main memory.

Structure of a pipeline (a DAG, not just a chain):

  * ``stages`` are *untiled* PPL patterns sharing one 1-D streaming
    domain ``(n,)``; they may be given in any order -- ``validate``
    topologically sorts them and rejects cycles.
  * A stage reads an earlier intermediate as an ``ir.Tensor`` whose
    ``name`` equals the producing stage's ``name`` (a *virtual* tensor:
    it exists in main memory only on the unfused path).  One
    intermediate may feed several consumers (fan-out); every non-output
    stage must be a producer ``Map``.
  * ``outputs`` names the terminal stages.  When omitted it is inferred
    as the stages nothing else consumes.  Terminals may be reductions
    (``MultiFold`` fold / ``GroupByFold``) *or* ``Map``s -- a Map
    terminal writes one output block per grid step, never revisited.

``fuse_dag`` builds the fused tiled IR: each terminal is strip-mined
onto the shared strided outer and every producer becomes a per-tile
stage via ``fusion.fuse_dag_stages`` -- a fan-out producer is lifted
*exactly once* and its single ``TileCopy`` (stable ``uid``) is shared
by all consumers.  Each terminal's fused form is ordinary tiled PPL:
``codegen_torch.execute`` is the oracle per terminal,
``memory.plan_memory`` accepts the whole terminal set (shared buffers
counted once), and ``codegen_cuda.lower_fused_dag`` emits the single
multi-output megakernel.

Joint tile-size selection lives in ``dse.explore_pipeline`` (priced on
the fused DAG, per-group block sizes on the split-fallback path).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import ir
from .affine import AffineMap
from .cost import DEFAULT_TIER, ONCHIP_WORDS, traffic
from .fusion import fuse_dag_stages, tile_copy_key
from .memory import plan_memory
from .scheduling import Metapipeline, build_schedule
from .strip_mine import insert_tile_copies


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """A DAG of untiled patterns over one shared streaming domain.

    ``outputs=()`` infers the terminal set: every stage no other stage
    consumes.  Chains need no change -- the last stage is the single
    inferred output.

    The fused lowering path (``fuse_dag`` -> ``codegen_cuda.
    lower_fused_pipeline``) runs the whole DAG as one megakernel with
    intermediates on chip; ``dse.explore_pipeline`` picks the block
    size and the metapipeline buffer depth jointly (see ``schedule`` /
    ``fused_memory_plan``'s ``depth`` knob) and falls back to
    contiguous topological splits when nothing fits the budget.
    """

    name: str
    stages: Tuple[ir.Pattern, ...]
    outputs: Tuple[str, ...] = ()

    def __post_init__(self):
        validate(self)

    @property
    def terminals(self) -> Tuple[ir.Pattern, ...]:
        sm = stage_map(self)
        return tuple(sm[n] for n in output_names(self))

    @property
    def shared_extent(self) -> int:
        return self.stages[0].domain[0]

    @property
    def dtype(self) -> str:
        return self.terminals[0].dtype


# --------------------------------------------------------------------------
# DAG structure helpers
# --------------------------------------------------------------------------


def stage_map(pipe: Pipeline) -> Dict[str, ir.Pattern]:
    return {s.name: s for s in pipe.stages}


def _edges(pipe: Pipeline) -> Tuple[Tuple[str, str], ...]:
    """(producer, consumer) name pairs: every read of a stage-named
    Tensor is intermediate wiring."""
    names = {s.name for s in pipe.stages}
    out = []
    for s in pipe.stages:
        for a in s.accesses:
            if isinstance(a.src, ir.Tensor) and a.src.name in names:
                out.append((a.src.name, s.name))
    return tuple(out)


def consumers(pipe: Pipeline) -> Dict[str, Tuple[str, ...]]:
    """Stage name -> names of the stages that read its output."""
    by_prod: Dict[str, List[str]] = {s.name: [] for s in pipe.stages}
    for prod, cons in _edges(pipe):
        if cons not in by_prod[prod]:
            by_prod[prod].append(cons)
    return {k: tuple(v) for k, v in by_prod.items()}


def output_names(pipe: Pipeline) -> Tuple[str, ...]:
    if pipe.outputs:
        return tuple(pipe.outputs)
    cons = consumers(pipe)
    return tuple(s.name for s in topo_stages(pipe) if not cons[s.name])


def topo_stages(pipe: Pipeline) -> Tuple[ir.Pattern, ...]:
    """Stages in canonical topological order (Kahn's algorithm, stage
    name as the deterministic tiebreak so the order -- and therefore the
    DSE cache signature -- is independent of the declaration order).
    Raises ValueError on a dependency cycle."""
    sm = stage_map(pipe)
    indeg = {n: 0 for n in sm}
    succ: Dict[str, List[str]] = {n: [] for n in sm}
    for prod, cons in set(_edges(pipe)):
        indeg[cons] += 1
        succ[prod].append(cons)
    ready = sorted(n for n, d in indeg.items() if d == 0)
    order: List[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        newly = []
        for m in succ[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                newly.append(m)
        ready = sorted(ready + newly)
    if len(order) != len(sm):
        stuck = sorted(n for n, d in indeg.items() if d > 0)
        raise ValueError(
            f"pipeline '{pipe.name}' has a dependency cycle through "
            f"stages {stuck}")
    return tuple(sm[n] for n in order)


def intermediate_names(pipe: Pipeline) -> Tuple[str, ...]:
    """Non-output stage names, i.e. the virtual tensors produced and
    consumed inside the DAG (topological order)."""
    outs = set(output_names(pipe))
    return tuple(s.name for s in topo_stages(pipe) if s.name not in outs)


def intermediate_words(pipe: Pipeline) -> Dict[str, int]:
    sm = stage_map(pipe)
    return {n: int(np.prod(sm[n].shape)) for n in intermediate_names(pipe)}


def external_inputs(pipe: Pipeline) -> Tuple[ir.Tensor, ...]:
    """Main-memory tensors read by any stage, minus the intermediates."""
    names = {s.name for s in pipe.stages}
    seen: Dict[str, ir.Tensor] = {}
    for s in pipe.stages:
        for t in ir.inputs_of(s):
            if t.name not in names:
                seen.setdefault(t.name, t)
    return tuple(seen.values())


def output_words(pipe: Pipeline) -> int:
    """Total words written to main memory for the pipeline outputs."""
    total = 0
    for t in pipe.terminals:
        total += int(np.prod(t.shape)) if t.shape else 1
    return total


def ragged_extent(pipe: Pipeline) -> Optional[ir.RaggedExtent]:
    """The pipeline's shared ragged extent, or None when every stage
    streams the full static domain (``validate`` already enforced that
    all ragged stages agree)."""
    for s in pipe.stages:
        rag = getattr(s, "ragged", None)
        if rag is not None:
            return rag
    return None


def _is_stream_row_access(a: ir.Access, domain_rank: int) -> bool:
    """True iff the access reads the *current* row along the shared
    streaming domain (base 0, dim 0 advancing 1:1 with the index)."""
    try:
        amap = AffineMap.probe(a.index_map, domain_rank)
    except Exception:
        return False
    if amap.n_out == 0:
        return False
    row_col = (1,) + (0,) * (amap.n_out - 1)
    return amap.base == (0,) * amap.n_out and amap.col(0) == row_col


def validate(pipe: Pipeline) -> None:
    if not pipe.stages:
        raise ValueError("empty pipeline")
    names = set()
    for s in pipe.stages:
        if s.name in names:
            raise ValueError(f"duplicate stage name '{s.name}'")
        names.add(s.name)
    if len(pipe.stages[0].domain) != 1:
        raise ValueError(
            "pipeline stages need a 1-D streaming domain, got "
            f"{pipe.stages[0].domain}")
    (n,) = pipe.stages[0].domain
    for s in pipe.stages:
        if tuple(s.domain) != (n,):
            raise ValueError(
                f"stage '{s.name}' domain {s.domain} != shared ({n},)")
        if s.strided or s.loads:
            raise ValueError(f"stage '{s.name}' must be untiled")

    # ragged streaming domains: every ragged stage must agree on the
    # bound / length scalar / granularity (one live extent per stream),
    # and the static bound must equal the shared domain
    rags = {s.name: s.ragged for s in pipe.stages
            if getattr(s, "ragged", None) is not None}
    if rags:
        uniq = set(rags.values())
        if len(uniq) > 1:
            raise ValueError(
                f"pipeline '{pipe.name}' stages disagree on the ragged "
                f"extent: {sorted(rags)}")
        (rag,) = uniq
        if rag.max != n:
            raise ValueError(
                f"ragged extent max={rag.max} != shared domain ({n},)")
        if n % rag.granularity != 0:
            raise ValueError(
                f"ragged granularity {rag.granularity} must divide the "
                f"shared domain {n}")

    # wiring: reads of stage-named Tensors must match the producer's
    # realized shape exactly (fan-out into a differently-shaped view
    # would silently read garbage on the fused path)
    sm = stage_map(pipe)
    for s in pipe.stages:
        for a in s.accesses:
            if isinstance(a.src, ir.Tensor) and a.src.name in names:
                prod = sm[a.src.name]
                if tuple(a.src.shape) != tuple(prod.shape):
                    raise ValueError(
                        f"stage '{s.name}' reads intermediate "
                        f"'{a.src.name}' with mismatched extents "
                        f"{tuple(a.src.shape)}; stage '{prod.name}' "
                        f"produces {tuple(prod.shape)}")

    # explicit outputs must name stages
    for o in pipe.outputs:
        if o not in names:
            raise ValueError(
                f"pipeline '{pipe.name}' output '{o}' names no stage")

    topo = topo_stages(pipe)  # raises on cycles
    cons = consumers(pipe)
    outs = output_names(pipe)
    if pipe.outputs:
        for s in topo:
            if s.name not in set(outs) and not cons[s.name]:
                raise ValueError(
                    f"dangling intermediate '{s.name}': produced but "
                    "never consumed and not a pipeline output")
        for o in outs:
            if cons[o]:
                raise NotImplementedError(
                    f"output stage '{o}' is also consumed by "
                    f"{list(cons[o])}; a stage cannot be both a "
                    "terminal and an intermediate")

    # producers (non-terminal stages) must be Maps
    for s in topo:
        if s.name not in set(outs) and not isinstance(s, ir.Map):
            raise NotImplementedError(
                f"producer stage '{s.name}' must be a Map")

    # a Map terminal streams one write-once output block per grid step;
    # a non-current-row read of an intermediate would force the outer to
    # revisit earlier tiles, which the template cannot do
    for o in outs:
        t = sm[o]
        if not isinstance(t, ir.Map):
            continue
        for a in t.accesses:
            if isinstance(a.src, ir.Tensor) and a.src.name in names \
                    and not _is_stream_row_access(a, 1):
                raise ValueError(
                    f"Map terminal '{t.name}' would need a revisited "
                    f"outer: its read of intermediate '{a.src.name}' is "
                    "not the current streamed row")


# --------------------------------------------------------------------------
# Fused IR
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedDag:
    """The fused form of a pipeline DAG at one streaming tile size.

    ``terminals`` pairs each output name with its fused tiled pattern
    (a 1-D strided outer whose producer stages are pattern-valued
    TileCopies).  The per-terminal patterns *share* producer TileCopies
    by ``uid`` -- that sharing is the fan-out contract: one on-chip
    scratch buffer and one set of main-memory feeds per producer, regardless of
    how many consumers it has.  ``refcounts`` records the consumer
    count per producer stage.
    """

    name: str
    block: int
    grid: int
    terminals: Tuple[Tuple[str, ir.Pattern], ...]
    refcounts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def patterns(self) -> Tuple[ir.Pattern, ...]:
        return tuple(p for _, p in self.terminals)


def fuse_dag(pipe: Pipeline, block: int, *,
             vmem_budget_words: int = ONCHIP_WORDS) -> FusedDag:
    """The whole DAG as per-terminal tiled patterns sharing producer
    stages: producers are on-chip per-tile stages (one TileCopy per
    producer, ref-counted across consumers), and only external tensors
    get (main memory -> on-chip) tile copies."""
    topo = topo_stages(pipe)
    outs = output_names(pipe)
    fused_by_name = fuse_dag_stages(topo, outs, block)
    terminals = []
    for o in outs:
        t = insert_tile_copies(fused_by_name[o],
                               vmem_budget_words=vmem_budget_words)
        terminals.append((o, t))
    cons = consumers(pipe)
    refcounts = {n: len(cons[n]) for n in intermediate_names(pipe)}
    return FusedDag(name=pipe.name, block=block,
                    grid=pipe.shared_extent // block,
                    terminals=tuple(terminals), refcounts=refcounts)


def fuse(pipe: Pipeline, block: int, *,
         vmem_budget_words: int = ONCHIP_WORDS) -> ir.Pattern:
    """Single-output convenience: the fused DAG's one terminal pattern
    (the chain API)."""
    fdag = fuse_dag(pipe, block, vmem_budget_words=vmem_budget_words)
    if len(fdag.terminals) != 1:
        raise ValueError(
            f"pipeline '{pipe.name}' has multiple outputs "
            f"{output_names(pipe)}; use fuse_dag")
    return fdag.terminals[0][1]


def schedule(pipe: Pipeline, block: int, *,
             vmem_budget_words: int = ONCHIP_WORDS,
             depth: int = 2) -> Optional[Metapipeline]:
    """Metapipeline schedule of the fused kernel (the first terminal's
    tree -- producer stages and boundary-crossing loads all buffered at
    ``depth`` rotating copies, 2 = classic double buffer; shared stages
    appear identically in every terminal's schedule).
    ``dse.explore_pipeline`` searches ``depth`` jointly with the block
    size and records the choice in ``PipelinePlan.depths``."""
    fdag = fuse_dag(pipe, block, vmem_budget_words=vmem_budget_words)
    return build_schedule(fdag.terminals[0][1], vmem_budget_words,
                          depth=depth)


# --------------------------------------------------------------------------
# Reference execution (unfused path + oracle)
# --------------------------------------------------------------------------


def _as_output(pipe: Pipeline, env: Dict[str, Any]):
    outs = output_names(pipe)
    if len(outs) == 1:
        return env[outs[0]]
    return {n: env[n] for n in outs}


def run_unfused(pipe: Pipeline, inputs: Dict[str, Any],
                *, return_intermediates: bool = False, device=None,
                batched_folds: bool = False):
    """Execute stage-by-stage (topological order) through the
    ``codegen_torch`` oracle, materializing every intermediate (the
    pre-fusion lowering: one kernel per pattern, intermediates
    round-trip main memory).  Multi-output DAGs return a name -> tensor
    dict.  Runs on CUDA unless ``device`` says otherwise;
    ``batched_folds`` as in ``codegen_torch.execute``."""
    from .codegen_torch import as_inputs, execute  # local: avoid cycle

    env = as_inputs(inputs, device)
    for s in topo_stages(pipe):
        env[s.name] = execute(s, env, device=device,
                              batched_folds=batched_folds)
    out = _as_output(pipe, env)
    if return_intermediates:
        return out, {k: env[k] for k in intermediate_names(pipe)}
    return out


def unfused_runner(pipe: Pipeline, *, device=None) -> Callable:
    """A closure over the unfused stage DAG (inputs as kwargs): the
    plain torch chain of per-stage oracle executions."""
    from ..device import resolve

    dev = resolve(device)

    def run(**inputs):
        return run_unfused(pipe, inputs, device=dev)

    return run


# --------------------------------------------------------------------------
# Traffic accounting (the quantity joint DSE minimizes)
# --------------------------------------------------------------------------


def unfused_traffic_words(pipe: Pipeline) -> int:
    """Total HBM words moved by the per-pattern lowering: every stage's
    main-memory reads (intermediates included -- they are real tensors
    on this path, and a fan-out intermediate is read once per consumer)
    plus every intermediate write plus the output writes."""
    words = 0
    for s in pipe.stages:
        words += traffic(s).total_reads
    words += sum(intermediate_words(pipe).values())
    words += output_words(pipe)
    return int(words)


def dag_external_reads(fdag: FusedDag) -> Dict[str, int]:
    """HBM words read per external tensor by the fused megakernel.

    Every tensor tile copy hangs off the shared 1-D strided outer, so a
    non-hoisted copy streams once per grid step and a hoisted copy is
    the Pipe-0 preload (loaded once).  Copies are deduplicated across
    terminals by ``fusion.tile_copy_key`` -- the kernel issues one DMA
    per distinct (tensor, index map, tile) regardless of how many
    terminal trees reference it -- and producer stages contribute
    nothing (they are on chip).
    """
    reads: Dict[str, int] = {}
    seen = set()
    for _, t in fdag.terminals:
        tree_tc: Dict[str, int] = {}   # this tree's copy words, undeduped
        streamed = set()
        for node in ir.walk(t):
            for tc in node.loads:
                if not isinstance(tc.src, ir.Tensor):
                    continue
                trips = 1 if tc.hoisted else fdag.grid
                words = trips * tc.words // tc.reuse
                tree_tc[tc.src.name] = (tree_tc.get(tc.src.name, 0)
                                        + words)
                key = tile_copy_key(tc)
                if key in seen:
                    continue
                seen.add(key)
                reads[tc.src.name] = reads.get(tc.src.name, 0) + words
            for a in node.accesses:
                if isinstance(a.src, ir.Tensor) and a.affine:
                    streamed.add(a.src.name)
        if streamed:
            # direct affine tensor reads left in place are the
            # streaming fallback (tile too big for on-chip): charge, once
            # per tree, whatever cost.traffic attributes to the tensor
            # beyond its tile copies (no cross-terminal CSE exists for
            # streamed reads)
            tr = traffic(t)
            for name in streamed:
                extra = tr.reads.get(name, 0) - tree_tc.get(name, 0)
                reads[name] = reads.get(name, 0) + max(extra, 0)
    return reads


def fused_traffic_words(pipe: Pipeline, block: int, *,
                        vmem_budget_words: int = ONCHIP_WORDS) -> int:
    """Total main-memory words moved by the fused megakernel: external
    reads of the fused DAG (intermediates are on chip, contributing zero;
    fan-out tiles counted once) plus the output writes."""
    fdag = fuse_dag(pipe, block, vmem_budget_words=vmem_budget_words)
    return int(sum(dag_external_reads(fdag).values())) + output_words(pipe)


def fused_memory_plan(pipe: Pipeline, block: int, *,
                      vmem_budget_bytes: int = DEFAULT_TIER.onchip_bytes,
                      depth: int = 2):
    """On-chip plan of the fused kernel across the whole terminal set
    (stage scratch charged at ``depth`` rotating copies -- 2 = classic
    double buffer -- so deeper buffering competes with bigger tiles
    under the budget; fan-out scratch counted once)."""
    fdag = fuse_dag(pipe, block,
                    vmem_budget_words=vmem_budget_bytes // 4)
    return plan_memory(fdag.patterns, vmem_budget_bytes=vmem_budget_bytes,
                       depth=depth)


# --------------------------------------------------------------------------
# Split-fallback support: contiguous topological sub-pipelines
# --------------------------------------------------------------------------


def sub_pipeline(pipe: Pipeline, i0: int, i1: int) -> Pipeline:
    """Stages ``topo[i0:i1]`` as their own pipeline.  Its outputs are
    the range's pipeline outputs plus every stage consumed outside the
    range (those intermediates round-trip HBM at the group boundary)."""
    topo = topo_stages(pipe)
    chosen = topo[i0:i1]
    inside = {s.name for s in chosen}
    pipe_outs = set(output_names(pipe))
    cons = consumers(pipe)
    outs = tuple(s.name for s in chosen
                 if s.name in pipe_outs
                 or any(c not in inside for c in cons[s.name]))
    return Pipeline(name=f"{pipe.name}:{chosen[0].name}",
                    stages=chosen, outputs=outs)


# --------------------------------------------------------------------------
# Lowering front-end (the `fused=True` path)
# --------------------------------------------------------------------------


def lower_pipeline(pipe: Pipeline, *, fused: bool = True, plan=None,
                   vmem_budget: Optional[int] = None, device=None,
                   tier=None, cache=None, measure=None, policy=None,
                   options=None) -> Callable:
    """Lower a pipeline to an executable callable.

    ``fused=True`` (default) runs the joint DSE on the card's budget
    (unless ``plan`` is given) and emits one CUDA megakernel per plan
    group (``codegen_cuda.lower_fused_pipeline``); ``fused=False``
    returns the per-stage oracle DAG -- the pre-fusion semantics every
    fused kernel is validated against.  Multi-output pipelines return a
    name -> tensor dict either way.  Runs on CUDA unless ``device`` says
    otherwise.  ``cache``, ``measure``, ``policy`` (a
    ``resilience.Policy``) and ``options`` pass through to the joint
    DSE: measured mode, per-candidate deadlines, quarantine,
    certification.
    """
    if not fused:
        return unfused_runner(pipe, device=device)
    from .codegen_cuda import lower_fused_pipeline
    return lower_fused_pipeline(pipe, plan=plan, vmem_budget=vmem_budget,
                                device=device, tier=tier, cache=cache,
                                measure=measure, policy=policy,
                                options=options)
