#!/usr/bin/env python3
"""cProfile the host-side pipeline stages (no accelerator needed).

Profiles, over N workload events:
  A. extraction      (BAM read retrieval + decode, reads/extraction.py)
  B. analysis        (align_and_disambiguate + count_and_genotype with
                      precomputed scores, i.e. exactly the worker-side
                      work of the pipelined orchestrator)
  C. dispatch tables (build_pair_tables host cost, parent-side)

Usage: JAX_PLATFORMS=cpu python tools/prof_host.py [--events 64]
"""
import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "tests", "tools"))


def report(name, pr, seconds, n):
    s = io.StringIO()
    stats = pstats.Stats(pr, stream=s)
    stats.sort_stats("cumulative").print_stats(18)
    print(f"\n===== {name}: {seconds:.2f}s total, "
          f"{seconds / n * 1e3:.1f} ms/event =====")
    lines = s.getvalue().splitlines()
    for line in lines[4:40]:
        print(line)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=64)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()

    from make_workload import generate

    wl = f"/tmp/prof_host_wl{args.events}_s{args.seed}"
    if not os.path.isfile(os.path.join(wl, "truth.json")):
        generate(wl, n_events=args.events, seed=args.seed)

    from paragraph_tpu.pipeline.multigrmpy import (
        MultigrmpyOptions, load_graph_description)
    from paragraph_tpu.pipeline.grmpy import (
        GrmpyParameters, _make_paragraph_parameters, count_and_genotype)
    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.io.cram import open_alignment_reader
    from paragraph_tpu.reads.extraction import extract_reads
    from paragraph_tpu.pipeline.paragraph import (
        Parameters, align_and_disambiguate)
    from paragraph_tpu.graph.model import SequenceGraph
    from paragraph_tpu.reads.read import UNMAPPED

    opts = MultigrmpyOptions(
        input=os.path.join(wl, "candidates.vcf"),
        manifest=os.path.join(wl, "samples.txt"),
        reference=os.path.join(wl, "ref.fa"),
        output=os.path.join(wl, "out_prof"),
        split_type="superloci")
    os.makedirs(opts.output, exist_ok=True)
    t0 = time.perf_counter()
    graph_descs = load_graph_description(opts)
    print(f"convert_input: {time.perf_counter() - t0:.2f}s "
          f"for {len(graph_descs)} events")
    manifest = load_manifest(opts.manifest)
    ref = opts.reference
    params = GrmpyParameters()

    sample = manifest[0]
    reader = open_alignment_reader(sample.filename, sample.index_filename,
                                   ref)

    # ---- A: extraction ----
    pps = []
    for gd in graph_descs:
        pp = Parameters()
        pp.max_reads = params.max_reads
        pp.load(gd, ref)
        pps.append(pp)
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    reads_per_event = []
    for pp in pps:
        reads_per_event.append(extract_reads(
            reader, pp.target_regions, pp.max_reads,
            pp.longest_alt_insertion))
    pr.disable()
    te = time.perf_counter() - t0
    report("extraction", pr, te, len(graph_descs))

    # ---- scores via the CPU's plain XLA fill (not profiled) ----
    from paragraph_tpu.ops.multi_sw import PairedGraphSW

    graphs = []
    pparams = []
    for gd in graph_descs:
        pp2 = _make_paragraph_parameters(params, gd, ref, False)
        pparams.append(pp2)
        graphs.append(SequenceGraph.from_json(pp2.description, ref))
    t0 = time.perf_counter()
    sw = PairedGraphSW(graphs)
    batches = [[r.bases.upper() for r in reads if r.bases]
               for reads in reads_per_event]
    scores = sw.score_pairs(batches)
    print(f"scoring (xla fill): {time.perf_counter() - t0:.2f}s")

    # ---- C: dispatch tables (parent-side cost per round) ----
    from paragraph_tpu.ops.multi_sw import (
        build_pair_tables, pair_tiles, pair_count, TILE_BUDGET, M_FLOOR,
        _pow2_at_least, _bucket)
    import numpy as np

    blob_batches = []
    for reads in batches:
        lens = np.fromiter((len(r) for r in reads), np.int32,
                           count=len(reads))
        blob_batches.append(("".join(reads).encode(), lens))
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for rep in range(3):
        for c, idxs in enumerate(sw.chunk_pairs):
            sub = [blob_batches[p] for p in idxs]
            tiles_raw = sum(pair_tiles(pair_count(r), 128) for r in sub)
            tiles_to = _pow2_at_least(tiles_raw, TILE_BUDGET)
            build_pair_tables(sw.chunk_arrays[c], sub, 128,
                              max(M_FLOOR, 160), tiles_to=tiles_to,
                              bases_to=tiles_to * 32,
                              l_ev_floor=sw.l_ev)
    pr.disable()
    tc = time.perf_counter() - t0
    report("build_pair_tables x3", pr, tc, 3 * len(graph_descs))

    # ---- B: analysis with precomputed scores ----
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    results = []
    for gi, gd in enumerate(graph_descs):
        pp2 = pparams[gi]
        reads = reads_per_event[gi]
        for r in reads:
            if r.bases:
                r.graph_mapping_status = UNMAPPED
        f_out, r_out = scores[gi]
        sc = (f_out[0], f_out[4], r_out[4], f_out[1], f_out[2], f_out[3])
        output = align_and_disambiguate(
            pp2, reads, graph=graphs[gi], precomputed_scores=sc)
        output["bam"] = sample.filename
        for key in ("alignments", "node_coverage", "path_coverage",
                    "phasing", "variants"):
            output.pop(key, None)
        s2 = __import__("copy").copy(sample)
        s2.alignment_data = output
        results.append(count_and_genotype(gd, ref, None, [s2]))
    pr.disable()
    tb = time.perf_counter() - t0
    report("analysis", pr, tb, len(graph_descs))

    print(json.dumps({"extract_ms_per_event": te / len(graph_descs) * 1e3,
                      "tables_ms_per_event": tc / 3 / len(graph_descs) * 1e3,
                      "analysis_ms_per_event": tb / len(graph_descs) * 1e3}))


if __name__ == "__main__":
    main()
