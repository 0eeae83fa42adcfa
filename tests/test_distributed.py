"""Mesh-sharded scoring (parallel/distributed.py) on the virtual 8-device
CPU mesh: sharded outputs must be bit-identical to the single-device
paired scorer, and the real grmpy pipeline must produce identical
genotypes whether events are sharded over the mesh or run serially."""
import json
import random

import jax
import pytest

from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu.ops.multi_sw import PairedGraphSW
from paragraph_tpu.parallel.distributed import (ShardedPairedSW,
                                                make_event_mesh)

from test_gssw_vs_reference import _random_graph, _read_from_graph


def _make_graph(seqs, edges):
    g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    return g


@pytest.mark.parametrize("n_pairs", [3, 9, 17])
def test_sharded_matches_single_device(n_pairs):
    assert jax.device_count() >= 8
    rng = random.Random(1000 + n_pairs)
    graphs = []
    reads_per_pair = []
    for _ in range(n_pairs):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=18)
        graphs.append(_make_graph(seqs, edges))
        reads = []
        for _ in range(rng.randint(0, 5)):
            r = _read_from_graph(rng, seqs, edges,
                                 read_len=rng.randint(6, 24))
            if r:
                reads.append(r)
        reads_per_pair.append(reads)

    sharded = ShardedPairedSW(graphs, mesh=make_event_mesh(8))
    single = PairedGraphSW(graphs)
    got = sharded.score_pairs(reads_per_pair)
    want = single.score_pairs(reads_per_pair)
    for k in range(n_pairs):
        for side in range(2):
            for name, a, b in zip(
                    ("score", "end_node", "end_ref", "end_read", "multi"),
                    got[k][side], want[k][side]):
                assert (a == b).all(), (k, side, name)


def test_sharded_multi_round():
    """More slots than devices -> several sharded rounds."""
    rng = random.Random(77)
    graphs = []
    reads_per_pair = []
    for _ in range(5):
        seqs, edges = _random_graph(rng, max_nodes=4, max_len=16)
        graphs.append(_make_graph(seqs, edges))
        r = _read_from_graph(rng, seqs, edges, read_len=12)
        reads_per_pair.append([r] if r else ["ACGTACGTACGT"])
    # one pair per slot, 2-device mesh -> 3 rounds
    sharded = ShardedPairedSW(graphs, mesh=make_event_mesh(2),
                              col_budget=1)
    assert len(sharded.rounds) == 3
    got = sharded.score_pairs(reads_per_pair)
    want = PairedGraphSW(graphs).score_pairs(reads_per_pair)
    for k in range(5):
        for side in range(2):
            for a, b in zip(got[k][side], want[k][side]):
                assert (a == b).all()


@pytest.mark.slow
def test_grmpy_pipeline_sharded_equals_serial(monkeypatch):
    """The real run_grmpy: batch mode (auto-sharded on the multi-device
    mesh) vs the serial per-event path must emit identical genotypes."""
    import os

    from paragraph_tpu.genotyping.sample_info import load_manifest
    from paragraph_tpu.pipeline.grmpy import GrmpyParameters, run_grmpy

    LD = "/root/reference/share/test-data/paragraph/long-del"
    monkeypatch.chdir("/root/reference")
    graph = json.load(
        open(os.path.join(LD, "chrX_graph_typing.2sample.json")))
    reference = os.path.join(LD, "chrX_graph_typing.fa")
    gt_params = json.load(open(os.path.join(LD, "param.json")))

    def run(batch):
        manifest = load_manifest(
            os.path.join(LD, "chrX_graph_typing.manifest"))
        # three graph copies so the batch path spreads over shards
        return run_grmpy([graph, dict(graph), dict(graph)], reference,
                         manifest, gt_params, GrmpyParameters(),
                         batch_events=batch)

    sharded = run(True)
    serial = run(False)

    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items() if k != "engine"}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    assert json.dumps(strip(sharded), sort_keys=True) == \
        json.dumps(strip(serial), sort_keys=True)
