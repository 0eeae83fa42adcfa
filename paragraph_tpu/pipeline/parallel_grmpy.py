"""Pipelined multi-process grmpy: extraction → device scoring → analysis.

The reference parallelises grmpy with two thread pools — one over
(sample × graph) alignment, one over graphs for genotyping
(/root/reference/src/c++/lib/grmpy/Workflow.cpp:224-231) — and overlaps
disk I/O with compute through those pools. This restructuring
separates the three fundamentally different resources and pipelines them
over fixed-size *rounds* of events:

  worker processes   extract round k+1      (BAM/CRAM I/O + decode)
  device             scores round k         (one async multi-event batch,
                                             ops/multi_sw.py)
  worker processes   analyse round k-1      (disambiguation, counting,
                                             variants, genotyping — pure
                                             Python, GIL-bound, so
                                             processes not threads)

Peak RAM is bounded by ~2 rounds of reads regardless of how many events
the run carries (the round-2 batch path materialised every read of every
event before the first dispatch). Output is event-ordered and identical
to the sequential path: workers run the same per-event code on the same
device scores.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

logger = logging.getLogger("grmpy")

_WORKER_STATE: Dict[str, object] = {}


def _worker_init():
    """Worker processes never open the device: scoring happens in the
    parent, which keeps one process per card (a JAX process reserves
    most of the card's memory when it first uses it). Force the CPU
    backend before anything imports jax."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    _WORKER_STATE["readers"] = {}
    _WORKER_STATE["event_reads"] = {}
    # pre-import the analysis stack now, while the parent is still
    # converting input and extracting round 0 — all later tasks hit warm
    # modules instead of paying ~0.7s of imports on the critical path
    from ..graph.model import SequenceGraph  # noqa: F401
    from ..reads.extraction import extract_reads  # noqa: F401
    from .grmpy import count_and_genotype  # noqa: F401
    from .paragraph import align_and_disambiguate  # noqa: F401


def _get_reader(filename: str, index_filename: str, reference_path: str):
    readers = _WORKER_STATE.setdefault("readers", {})
    reader = readers.get(filename)
    if reader is None:
        from ..io.cram import open_alignment_reader

        reader = open_alignment_reader(filename, index_filename,
                                       reference_path)
        readers[filename] = reader
    return reader


def _extract_reads_map(graph_desc: dict, reference_path: str,
                       bam_specs: List[tuple], max_reads: int):
    """{sample_name: [Read, ...]} for one event (grmpy::alignSingleSample's
    extraction half, AlignSamples.cpp:115-147)."""
    from ..reads.extraction import extract_reads
    from .paragraph import Parameters

    pp = Parameters()
    pp.max_reads = max_reads
    pp.load(graph_desc, reference_path)
    out = {}
    for sample_name, filename, index_filename in bam_specs:
        reader = _get_reader(filename, index_filename, reference_path)
        out[sample_name] = extract_reads(
            reader, pp.target_regions, pp.max_reads,
            pp.longest_alt_insertion)
    return out


def _extract_event(gi: int, graph_desc: dict, reference_path: str,
                   bam_specs: List[tuple], max_reads: int):
    """Extract one event's reads, keep the Read objects in this worker
    (the analysis task for the same event is routed back here), and
    return only what the parent's device scoring needs: per sample, the
    upper-cased bases of scoreable reads as one blob + lengths. Read
    objects never cross the process boundary — with few host cores the
    parent's unpickle time is pipeline critical path."""
    reads_map = _extract_reads_map(graph_desc, reference_path, bam_specs,
                                   max_reads)
    _WORKER_STATE.setdefault("event_reads", {})[gi] = reads_map
    out = {}
    for sample_name, reads in reads_map.items():
        bases = [r.bases.upper() for r in reads if r.bases]
        import numpy as np

        lens = np.fromiter((len(b) for b in bases), np.int32,
                           count=len(bases))
        out[sample_name] = ("".join(bases).encode(), lens)
    return out


def _analyze_event(gi: int, graph_desc: dict, reference_path: str,
                   genotyping_parameters: Optional[dict],
                   parameters, per_sample: List[tuple],
                   bam_specs: List[tuple], max_reads: int,
                   defer_genotyping: bool = False):
    """Per-event host analysis + genotyping for all samples.

    per_sample: (SampleInfo, has_reads, precomputed-scores-or-None);
    has_reads=False means the sample carries pre-aligned alignment_data.
    Reads come from this worker's extraction cache (same event was
    extracted here — the parent routes both tasks to one worker); a
    cache miss (e.g. worker restart) re-extracts locally.
    Returns the event's genotyping result dict (CountAndGenotype.cpp).
    """
    from ..graph.model import SequenceGraph
    from ..reads.read import UNMAPPED
    from .grmpy import _make_paragraph_parameters, count_and_genotype

    reads_map = _WORKER_STATE.setdefault("event_reads", {}).pop(gi, None)
    if reads_map is None and any(h for _, h, _ in per_sample):
        reads_map = _extract_reads_map(graph_desc, reference_path,
                                       bam_specs, max_reads)

    # one native thread per worker: the orchestrator already runs one
    # worker process per host core, so auto-threading inside the native
    # traceback would oversubscribe the cores against the sibling worker
    import copy as _copy

    parameters = _copy.copy(parameters)
    parameters.threads = 1

    pp = None
    graph = None
    samples = []
    for sample, has_reads, scores in per_sample:
        if has_reads:
            reads = reads_map[sample.sample_name]
            if pp is None:
                pp = _make_paragraph_parameters(
                    parameters, graph_desc, reference_path, False)
                graph = SequenceGraph.from_json(
                    pp.description, reference_path)
            from .paragraph import align_and_disambiguate

            for r in reads:
                if r.bases:
                    r.graph_mapping_status = UNMAPPED
            output = align_and_disambiguate(
                pp, reads, graph=graph, precomputed_scores=scores)
            output["bam"] = sample.filename
            for key in ("alignments", "node_coverage", "path_coverage",
                        "phasing", "variants"):
                output.pop(key, None)
            sample.alignment_data = output
        samples.append(sample)
    if defer_genotyping:
        # device genotyping engine: the parent collects every event's
        # per-sample alignment data and genotypes the whole run in one
        # sharded mesh dispatch (genotyping/device_engine.py)
        return samples
    return count_and_genotype(graph_desc, reference_path,
                              genotyping_parameters, samples, graph=graph)


def run_grmpy_pipelined(graph_descs: List[dict], reference_path: str,
                        manifest, genotyping_parameters: Optional[dict],
                        parameters, round_events: int = 0,
                        workers: int = 0) -> List[dict]:
    """Event-ordered genotyping results for every graph, produced by the
    3-stage pipeline described in the module docstring."""
    import multiprocessing
    import time

    import jax

    from ..align.batched_aligner import resolve_threads

    workers = workers or resolve_threads(parameters.threads)
    n_events = len(graph_descs)
    if not round_events:
        # align rounds with the scorer's chunk budget so single-sample
        # rounds fill exactly one dispatch (PAIR_BUDGET pairs) instead
        # of one full + one fragment; multi-sample rounds shrink so a
        # round stays a small number of full chunks
        from ..ops.multi_sw import PAIR_BUDGET

        n_align = max(1, sum(1 for s in manifest
                             if s.alignment_data is None))
        # single-sample rounds are 32 events; multi-sample rounds shrink
        # so one round is a few full chunks rather than a dozen (peak RAM
        # and dispatch-table size scale with round pairs)
        round_events = 32 if n_align == 1 else max(
            8, (PAIR_BUDGET // n_align) or 1)
    rounds = [list(range(r, min(r + round_events, n_events)))
              for r in range(0, n_events, round_events)]

    needs_align = [s for s in manifest if s.alignment_data is None]
    bam_specs = [(s.sample_name, s.filename, s.index_filename)
                 for s in needs_align]
    defer_genotyping = getattr(parameters, "gt_engine", "host") == "device"

    use_sharded = jax.device_count() > 1

    t_start = time.monotonic()
    progress_state = {"last": t_start}

    def report_progress(done: int) -> None:
        if not parameters.progress:
            return
        now = time.monotonic()
        if done == n_events or now - progress_state["last"] >= 10.0:
            progress_state["last"] = now
            logger.info("[progress] %d/%d events done", done, n_events)

    ctx = multiprocessing.get_context("spawn")
    extract_futs: Dict[int, object] = {}
    analysis_futs: List[Optional[object]] = [None] * n_events

    # children inherit os.environ at spawn: force the CPU backend there
    # before their interpreter starts, so only the parent opens the GPU
    child_env = {"JAX_PLATFORMS": "cpu"}
    saved_env = {k: os.environ.get(k) for k in child_env}
    os.environ.update(child_env)

    try:
        return _run_pipeline(
            ctx, workers, rounds, graph_descs, reference_path, manifest,
            needs_align, bam_specs, genotyping_parameters, parameters,
            use_sharded, extract_futs, analysis_futs, report_progress,
            n_events, defer_genotyping)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_pipeline(ctx, workers, rounds, graph_descs, reference_path,
                  manifest, needs_align, bam_specs, genotyping_parameters,
                  parameters, use_sharded, extract_futs, analysis_futs,
                  report_progress, n_events, defer_genotyping=False):
    import concurrent.futures
    import copy
    import time

    from ..graph.model import SequenceGraph
    from ..ops.multi_sw import PairedGraphSW

    stage_t: Dict[str, float] = {}

    def _clock(key, t0):
        now = time.perf_counter()
        stage_t[key] = stage_t.get(key, 0.0) + now - t0
        return now

    # one single-worker pool per host core: event gi's extraction AND
    # analysis both go to pool gi % W, so the Read objects extracted
    # there are still in that worker's cache when analysis arrives —
    # reads never cross a process boundary (see _extract_event)
    pools = [concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=ctx, initializer=_worker_init)
        for _ in range(workers)]
    try:

        def submit_extract(r: int) -> None:
            for gi in rounds[r]:
                extract_futs[gi] = pools[gi % workers].submit(
                    _extract_event, gi, graph_descs[gi], reference_path,
                    bam_specs, parameters.max_reads)

        kernel_stats: Dict[str, float] = {}
        engines = set()

        def finalize_and_analyze(pending) -> None:
            r, sw, handle, blobs_by_event = pending
            t0 = time.perf_counter()
            scores = None
            if handle is not None:
                scores = sw.finalize_pairs(handle)
                engines.add(f"{sw.engine}/{type(sw).__name__}")
                for k, v in getattr(sw, "stats", {}).items():
                    kernel_stats[k] = kernel_stats.get(k, 0) + v
            k = 0
            for gi in rounds[r]:
                per_sample = []
                for s in manifest:  # manifest order = output sample order
                    if s.alignment_data is not None:
                        per_sample.append((copy.copy(s), False, None))
                        continue
                    f_out, r_out = scores[k]
                    sc = (f_out[0], f_out[4], r_out[4],
                          f_out[1], f_out[2], f_out[3], sw.engine)
                    k += 1
                    per_sample.append((copy.copy(s), True, sc))
                analysis_futs[gi] = pools[gi % workers].submit(
                    _analyze_event, gi, graph_descs[gi], reference_path,
                    genotyping_parameters, parameters, per_sample,
                    bam_specs, parameters.max_reads, defer_genotyping)
            _clock("device_wait+submit", t0)

        pending_score = None
        submit_extract(0)
        def build_sw(r: int):
            """Scorer for round r. Graphs derive from the descriptions
            alone, so construction (GraphArrays build + resident device
            uploads) can run while the round's extraction is still in
            flight in the workers."""
            if not needs_align:
                return None
            graphs = []
            for gi in rounds[r]:
                graph = SequenceGraph.from_json(
                    _root_desc(graph_descs[gi]), reference_path)
                graphs.extend([graph] * len(needs_align))
            if use_sharded:
                from ..parallel.distributed import ShardedPairedSW

                return ShardedPairedSW(graphs)
            return PairedGraphSW(graphs)

        t0 = time.perf_counter()
        prebuilt_sw = {0: build_sw(0)} if rounds else {}
        _clock("graph_build", t0)
        for r in range(len(rounds)):
            if r + 1 < len(rounds):
                submit_extract(r + 1)
            sw = prebuilt_sw.pop(r, None)
            t0 = time.perf_counter()
            blobs_by_event = {gi: extract_futs.pop(gi).result()
                              for gi in rounds[r]}
            t0 = _clock("extract_wait", t0)

            # one scoring batch per (event × sample), in the same pair
            # order build_sw laid the graphs out
            # (blob, lens) tuples go straight to the scorer — encoding
            # happens once per dispatch from the concatenated bytes
            # (ops/batched_sw.py::encode_blob), with no per-read strings
            batches = [blobs_by_event[gi][s.sample_name]
                       for gi in rounds[r] for s in needs_align]

            handle = None
            if sw is not None:
                handle = sw.score_pairs_device(batches)
            t0 = _clock("score_dispatch", t0)

            if pending_score is not None:
                finalize_and_analyze(pending_score)
            pending_score = (r, sw, handle, blobs_by_event)

            # overlap the NEXT round's scorer construction with its
            # extraction and with the device crunching round r
            if r + 1 < len(rounds):
                t0 = time.perf_counter()
                prebuilt_sw[r + 1] = build_sw(r + 1)
                _clock("graph_build", t0)

            done = sum(1 for f in analysis_futs if f is not None
                       and f.done())
            report_progress(done)

        if pending_score is not None:
            finalize_and_analyze(pending_score)

        t0 = time.perf_counter()
        results = []
        if defer_genotyping:
            from ..genotyping.device_engine import genotype_events_on_device
            from .grmpy import make_event_genotyper

            genotypers = []
            for gi in range(n_events):
                samples = analysis_futs[gi].result()
                genotypers.append(make_event_genotyper(
                    graph_descs[gi], reference_path,
                    genotyping_parameters, samples))
            _clock("analysis_wait", t0)
            t0 = time.perf_counter()
            genotype_events_on_device(genotypers)
            for gi, gtr in enumerate(genotypers):
                results.append(gtr.get_genotypes())
                report_progress(gi + 1)
            _clock("device_genotype", t0)
        else:
            for gi in range(n_events):
                results.append(analysis_futs[gi].result())
                report_progress(gi + 1)
            _clock("analysis_wait", t0)
        logger.info("[pipeline] stage seconds: %s",
                    {k: round(v, 2) for k, v in sorted(stage_t.items())})
        if engines:
            # the sharded scorer keeps no per-dispatch counters: its
            # line names the engine and scorer with zero counts
            wait = kernel_stats.get("device_wait_s", 0.0)
            cells = kernel_stats.get("cells", 0)
            logger.info(
                "[kernel] engine/scorer=%s dispatches=%d cells=%.2fG "
                "device_wait=%.2fs eff=%.1f Gcells/s (upper bound; see "
                "engine_report) host: tables=%.2fs put=%.2fs call=%.2fs",
                ",".join(sorted(engines)), kernel_stats.get("dispatches", 0),
                cells / 1e9, wait,
                cells / wait / 1e9 if wait > 0 else 0.0,
                kernel_stats.get("tables_s", 0.0),
                kernel_stats.get("put_s", 0.0),
                kernel_stats.get("call_s", 0.0))
    finally:
        for ex in pools:
            ex.shutdown(wait=False, cancel_futures=True)
    return results


def _root_desc(graph_desc: dict) -> dict:
    root = dict(graph_desc)
    if "graph" in root:
        root.update(root["graph"])
        del root["graph"]
    return root
