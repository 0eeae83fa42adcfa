"""Multi-sample align + genotype workflow.

Equivalent of ``grmpy::Workflow`` + ``alignSingleSample`` +
``countAndGenotype`` (/root/reference/src/c++/lib/grmpy/Workflow.cpp,
AlignSamples.cpp, CountAndGenotype.cpp): for every (sample × graph) extract
reads and run the paragraph analysis, then genotype each graph across all
samples.
"""
from __future__ import annotations

import copy
import logging
import time
from typing import Dict, List, Optional

logger = logging.getLogger("grmpy")

from ..genotyping.graph_genotyper import GraphBreakpointGenotyper
from ..genotyping.sample_info import SampleInfo
from ..graph.model import SequenceGraph
from ..io.cram import open_alignment_reader as BamReader
from ..reads.extraction import extract_reads
from .paragraph import (ALL, DETAILED_READ_COUNTS, EDGE_READ_COUNTS,
                        HAPLOTYPES, NODE_READ_COUNTS, PATH_READ_COUNTS,
                        Parameters, align_and_disambiguate)


class GrmpyParameters:
    """grmpy::Parameters (grmpy/Parameters.hh)."""

    def __init__(self, threads: int = 0, max_reads: int = 10000,
                 bad_align_frac: float = 0.8,
                 path_sequence_matching: bool = False,
                 graph_sequence_matching: bool = True,
                 klib_sequence_matching: bool = False,
                 kmer_sequence_matching: bool = False,
                 bad_align_uniq_kmer_len: int = 0,
                 alignment_output_folder: str = "",
                 infer_read_haplotypes: bool = False,
                 progress: bool = False,
                 gt_engine: str = "auto"):
        self.threads = threads
        self.max_reads = max_reads
        self.bad_align_frac = bad_align_frac
        self.path_sequence_matching = path_sequence_matching
        self.graph_sequence_matching = graph_sequence_matching
        self.klib_sequence_matching = klib_sequence_matching
        self.kmer_sequence_matching = kmer_sequence_matching
        self.bad_align_uniq_kmer_len = bad_align_uniq_kmer_len
        self.alignment_output_folder = alignment_output_folder
        self.infer_read_haplotypes = infer_read_haplotypes
        self.progress = progress
        #: "host" = float64 parity engines per event;
        #: "device" = float32 population engine — one sharded mesh
        #: dispatch genotypes every (event × sample × breakpoint) of
        #: the run (genotyping/device_engine.py)
        self.gt_engine = gt_engine


def align_single_sample(parameters: GrmpyParameters, graph_desc: dict,
                        reference_path: str, reader: BamReader,
                        sample: SampleInfo) -> None:
    """grmpy::alignSingleSample (AlignSamples.cpp:115-172)."""
    import os

    write_alignments = (
        parameters.alignment_output_folder
        and os.path.isdir(parameters.alignment_output_folder))
    if write_alignments:
        output_options = ALL
    else:
        output_options = (NODE_READ_COUNTS | EDGE_READ_COUNTS
                          | PATH_READ_COUNTS | DETAILED_READ_COUNTS)
    if parameters.infer_read_haplotypes:
        output_options |= HAPLOTYPES
    else:
        output_options &= ~HAPLOTYPES

    paragraph_parameters = Parameters(
        parameters.max_reads,
        3 if write_alignments else parameters.max_reads + 1,
        0.01, parameters.bad_align_frac, output_options,
        parameters.path_sequence_matching,
        parameters.graph_sequence_matching,
        parameters.klib_sequence_matching,
        parameters.kmer_sequence_matching, False)
    paragraph_parameters.threads = parameters.threads
    paragraph_parameters.kmer_len = parameters.bad_align_uniq_kmer_len
    paragraph_parameters.load(graph_desc, reference_path)

    all_reads = extract_reads(
        reader, paragraph_parameters.target_regions, parameters.max_reads,
        paragraph_parameters.longest_alt_insertion)
    output = align_and_disambiguate(paragraph_parameters, all_reads)
    output["bam"] = sample.filename

    if write_alignments:
        _write_alignments_json(output, parameters, paragraph_parameters,
                               reference_path, sample)

    for key in ("alignments", "node_coverage", "path_coverage", "phasing",
                "variants"):
        output.pop(key, None)
    sample.alignment_data = output


def _write_alignments_json(output, parameters, paragraph_parameters,
                           reference_path, sample):
    """grmpy::writeAlignments (AlignSamples.cpp:57-109)."""
    import gzip
    import json
    import os
    import re

    out = dict(output)
    out["sample"] = sample.sample_name
    out["reference"] = reference_path
    unsafe = re.compile(r"[^A-Za-z0-9.-]")
    safe_sample = unsafe.sub("_", sample.sample_name)
    safe_regions = unsafe.sub(
        "_", "_".join(str(r) for r in paragraph_parameters.target_regions))
    graph = paragraph_parameters.description
    graph_id = graph.get("ID") or graph.get("model_name") or "graph"
    safe_graph_id = unsafe.sub("_", str(graph_id))
    path = os.path.join(
        parameters.alignment_output_folder,
        f"{safe_sample}-{safe_graph_id}-{safe_regions}.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump(out, f, sort_keys=True, indent=4, separators=(",", ": "))


def make_event_genotyper(graph_desc: dict, reference_path: str,
                         genotyping_parameters: Optional[dict],
                         samples: List[SampleInfo],
                         graph: Optional[SequenceGraph] = None
                         ) -> GraphBreakpointGenotyper:
    """Breakpoint genotyper for one event with all sample alignments
    added (the counting half of grmpy::countAndGenotype). Callers that
    already built the event's SequenceGraph (the per-event analysis
    does, for alignment) pass it to skip a second from_json build."""
    root = graph_desc if graph_desc is not None else (
        samples[0].alignment_data)
    if graph is None:
        graph = SequenceGraph.from_json(root, reference_path)

    male_ploidy = 2
    female_ploidy = 2
    for t_region in root.get("target_regions", []):
        chrom = str(t_region).split(":")[0]
        if chrom in ("chrX", "X"):
            male_ploidy = 1
        elif chrom in ("chrY", "Y"):
            male_ploidy = 1
            female_ploidy = 1

    genotyper = GraphBreakpointGenotyper(graph, male_ploidy, female_ploidy)
    genotyper.set_parameters(genotyping_parameters)
    for sample_info in samples:
        genotyper.add_alignment(sample_info)
    return genotyper


def count_and_genotype(graph_desc: dict, reference_path: str,
                       genotyping_parameters: Optional[dict],
                       samples: List[SampleInfo],
                       graph: Optional[SequenceGraph] = None) -> dict:
    """grmpy::countAndGenotype (CountAndGenotype.cpp:46-88)."""
    return make_event_genotyper(graph_desc, reference_path,
                                genotyping_parameters,
                                samples, graph=graph).get_genotypes()


def _make_paragraph_parameters(parameters: GrmpyParameters,
                               graph_desc: dict, reference_path: str,
                               write_alignments: bool) -> Parameters:
    if write_alignments:
        output_options = ALL
    else:
        output_options = (NODE_READ_COUNTS | EDGE_READ_COUNTS
                          | PATH_READ_COUNTS | DETAILED_READ_COUNTS)
    if parameters.infer_read_haplotypes:
        output_options |= HAPLOTYPES
    else:
        output_options &= ~HAPLOTYPES
    pp = Parameters(
        parameters.max_reads,
        3 if write_alignments else parameters.max_reads + 1,
        0.01, parameters.bad_align_frac, output_options,
        parameters.path_sequence_matching,
        parameters.graph_sequence_matching,
        parameters.klib_sequence_matching,
        parameters.kmer_sequence_matching, False)
    pp.threads = parameters.threads
    pp.kmer_len = parameters.bad_align_uniq_kmer_len
    pp.load(graph_desc, reference_path)
    return pp


def align_samples_batched(parameters: GrmpyParameters,
                          graph_descs: List[dict], reference_path: str,
                          manifest: List[SampleInfo],
                          readers: Dict[str, BamReader]):
    """Cross-event batched alignment: extract reads for every
    (graph × sample) pair, score ALL pairs' orientation batches in one (or
    few) device dispatches (ops/multi_sw.py), then finish each pair's
    host-side analysis with the injected scores. Output-identical to the
    sequential path.

    This replaces grmpy's thread pool over (sample × graph)
    (Workflow.cpp:224-231).
    """
    from ..graph.model import SequenceGraph
    from ..ops.multi_sw import PairedGraphSW
    from ..reads.read import UNMAPPED

    jobs = []  # (graph_desc, pp, graph, sample, reads)
    for graph_desc in graph_descs:
        graph = None
        pp_proto = None
        for sample in manifest:
            s = copy.copy(sample)
            if s.alignment_data is not None:
                jobs.append((graph_desc, None, None, s, None))
                continue
            if graph is None:
                pp_proto = _make_paragraph_parameters(
                    parameters, graph_desc, reference_path, False)
                graph = SequenceGraph.from_json(
                    pp_proto.description, reference_path)
            reader = readers.get(s.filename)
            if reader is None:
                reader = BamReader(s.filename, s.index_filename,
                                   reference_path)
                readers[s.filename] = reader
            reads = extract_reads(
                reader, pp_proto.target_regions, parameters.max_reads,
                pp_proto.longest_alt_insertion)
            jobs.append((graph_desc, pp_proto, graph, s, reads))

    # one multi-event scoring pass over all (graph × sample) pairs: each
    # pair's reads upload once; the 4 orientation variants derive on
    # device (ops/multi_sw.py expand_orientations). A failing device
    # scorer raises: there is no slower engine to fall back to.
    scoring_jobs = [j for j in jobs if j[4] is not None]
    precomputed = {}
    if scoring_jobs:
        graphs = []
        batches = []
        for idx, (gd, pp, graph, s, reads) in enumerate(scoring_jobs):
            live = [r for r in reads if r.bases]
            for r in live:
                r.graph_mapping_status = UNMAPPED
            graphs.append(graph)
            batches.append([r.bases.upper() for r in live])
        import jax

        if jax.device_count() > 1 and len(graphs) > 1:
            # events sharded over the device mesh (shard_map; the batched
            # counterpart of grmpy/Workflow.cpp:224-231's thread pool)
            from ..parallel.distributed import ShardedPairedSW

            paired = ShardedPairedSW(graphs)
        else:
            paired = PairedGraphSW(graphs)
        results = paired.score_pairs(batches)
        for k in range(len(scoring_jobs)):
            f_out, r_out = results[k]
            precomputed[k] = (f_out[0], f_out[4], r_out[4],
                              f_out[1], f_out[2], f_out[3], paired.engine)

    out_jobs = []
    for k, (gd, pp, graph, s, reads) in enumerate(scoring_jobs):
        output = align_and_disambiguate(
            pp, reads, graph=graph,
            precomputed_scores=precomputed.get(k))
        output["bam"] = s.filename
        for key in ("alignments", "node_coverage", "path_coverage",
                    "phasing", "variants"):
            output.pop(key, None)
        s.alignment_data = output
    return jobs


def run_grmpy(graph_descs: List[dict], reference_path: str,
              manifest: List[SampleInfo],
              genotyping_parameters: Optional[dict] = None,
              parameters: Optional[GrmpyParameters] = None,
              batch_events: Optional[bool] = None) -> List[dict]:
    """grmpy::Workflow::run (Workflow.cpp:191-239): align every
    (sample × graph), then genotype every graph; returns the list of
    genotyping result dicts (the genotypes.json array).

    batch_events=True scores all (graph × sample) pairs in one device
    dispatch (auto: enabled for multi-event runs without alignment dumps
    or non-default aligners).
    """
    if parameters is None:
        parameters = GrmpyParameters()

    if parameters.gt_engine == "auto":
        # population-scale multi-sample batches default to the sharded
        # float32 device engine (one mesh dispatch for every event x
        # sample x breakpoint job); small runs — including the 2-sample
        # round-trip parity oracle — stay on the float64 host engine,
        # whose outputs are bit-exact vs the reference model
        parameters = copy.copy(parameters)
        parameters.gt_engine = (
            "device" if len(manifest) >= 4 and len(graph_descs) >= 8
            else "host")

    if batch_events is None:
        batch_events = (
            len(graph_descs) > 1
            and not parameters.alignment_output_folder
            and not parameters.path_sequence_matching
            and not parameters.klib_sequence_matching
            and not parameters.kmer_sequence_matching
            and parameters.graph_sequence_matching)

    # large event batches run the 3-stage pipelined orchestrator
    # (pipeline/parallel_grmpy.py): worker processes extract round k+1
    # and analyse round k-1 while the device scores round k. threads=1
    # forces the single-process path (the reference's -t semantics).
    # With the device genotyping engine, workers defer genotyping and
    # the parent runs one sharded mesh dispatch over every
    # (event x sample x breakpoint) job at the end of the pipeline.
    if (batch_events and len(graph_descs) >= 8 and parameters.threads != 1
            and not parameters.alignment_output_folder):
        from concurrent.futures.process import BrokenProcessPool

        from .parallel_grmpy import run_grmpy_pipelined

        try:
            return run_grmpy_pipelined(graph_descs, reference_path,
                                       manifest, genotyping_parameters,
                                       parameters)
        except BrokenProcessPool as exc:
            # e.g. a parent whose __main__ cannot be re-imported by
            # multiprocessing spawn (REPL/stdin) — run single-process
            logger.warning(
                "worker pool unavailable (%s); falling back to the "
                "single-process batch path", exc)

    # grmpy --progress (Workflow.cpp:114-120,173-179): periodic
    # "N/M events done" lines, throttled to one every 10s plus a final one.
    progress_state = {"last": time.monotonic()}
    total_events = len(graph_descs)

    def report_progress(done: int) -> None:
        if not parameters.progress:
            return
        now = time.monotonic()
        if done == total_events or now - progress_state["last"] >= 10.0:
            progress_state["last"] = now
            logger.info("[progress] %d/%d events done", done, total_events)

    readers: Dict[str, BamReader] = {}
    results = []
    if batch_events:
        jobs = align_samples_batched(parameters, graph_descs,
                                     reference_path, manifest, readers)
        by_graph: Dict[int, List[SampleInfo]] = {}
        order = []
        for gd, pp, graph, s, reads in jobs:
            key = id(gd)
            if key not in by_graph:
                by_graph[key] = []
                order.append((key, gd))
            by_graph[key].append(s)
        if parameters.gt_engine == "device":
            # population-scale device genotyping: count every event on
            # the host, then genotype all (event × sample × breakpoint)
            # jobs in one sharded float32 mesh dispatch
            from ..genotyping.device_engine import genotype_events_on_device

            genotypers = [make_event_genotyper(
                gd, reference_path, genotyping_parameters, by_graph[key])
                for key, gd in order]
            genotype_events_on_device(genotypers)
            for gtr in genotypers:
                results.append(gtr.get_genotypes())
                report_progress(len(results))
            return results
        for key, gd in order:
            results.append(count_and_genotype(
                gd, reference_path, genotyping_parameters, by_graph[key]))
            report_progress(len(results))
        return results

    for graph_desc in graph_descs:
        graph_samples = []
        for sample in manifest:
            s = copy.copy(sample)
            if s.alignment_data is None:
                reader = readers.get(s.filename)
                if reader is None:
                    reader = BamReader(s.filename, s.index_filename,
                                       reference_path)
                    readers[s.filename] = reader
                align_single_sample(parameters, graph_desc, reference_path,
                                    reader, s)
            graph_samples.append(s)
        results.append(count_and_genotype(
            graph_desc, reference_path, genotyping_parameters,
            graph_samples))
        report_progress(len(results))
    return results
