"""Paired multi-event fill (ops/multi_sw.py): the plain XLA engine vs the
scalar oracle, engine choice, and the wrapper's padding and slicing."""
import random

import numpy as np
import pytest

from paragraph_tpu.align.graph_aligner import reverse_complement
from paragraph_tpu.align.gssw import GraphSW
from paragraph_tpu.graph.model import SequenceGraph
from paragraph_tpu.ops.multi_sw import (ENGINES, MultiGraphArrays,
                                        PairedGraphSW, build_pair_tables,
                                        pair_tiles, paired_fill,
                                        select_engine)

from test_gssw_vs_reference import _random_graph, _read_from_graph


def _make_graph(seqs, edges):
    g = SequenceGraph([f"n{i}" for i in range(len(seqs))], seqs)
    for f, t in edges:
        g.add_edge(f, t)
    return g


def check_against_oracle(graphs, reads_per_pair, results):
    """Every orientation of every read vs GraphSW.fill on the matching
    graph: score, end node, end offset, end read row, multi flag."""
    for g, reads, (f_out, r_out) in zip(graphs, reads_per_pair, results):
        fwd = [r.upper() for r in reads]
        rc = [reverse_complement(r) for r in fwd]
        for graph, batch, out in (
                (g, fwd + rc, f_out),
                (g.reversed(), [b[::-1] for b in fwd + rc], r_out)):
            assert all(len(x) == len(batch) for x in out)
            scalar = GraphSW(graph)
            for i, read in enumerate(batch):
                fills, max_node, max_score = scalar.fill(read)
                f = fills[max_node]
                want = (max_score, max_node, f.ref_end1, f.read_end1,
                        scalar.ends_at_multiple_nodes(fills, max_score))
                got = tuple(int(x[i]) for x in out)
                assert got[:4] == want[:4], (read, got, want)
                assert bool(got[4]) == bool(want[4]), (read, got, want)


def _case_multi_pred(rng):
    # node 3 has three predecessors, node 4 two
    g = _make_graph(["ACGTTGCA", "GGATC", "TTAGC", "CATCATG", "AGGTCA"],
                    [(0, 1), (0, 2), (0, 3), (1, 3), (2, 3), (1, 4),
                     (3, 4)])
    seqs = [g.node_seq(i) for i in range(g.num_nodes)]
    edges = g.edges()
    reads = [_read_from_graph(rng, seqs, edges, read_len=rng.randint(8, 20))
             for _ in range(5)]
    return [g], [[r for r in reads if r]]


def _case_empty_pairs(rng):
    graphs, rpp = [], []
    for k in range(4):
        seqs, edges = _random_graph(rng, max_nodes=5, max_len=18)
        graphs.append(_make_graph(seqs, edges))
        reads = [] if k % 2 else [
            _read_from_graph(rng, seqs, edges, read_len=rng.randint(8, 22))
            for _ in range(3)]
        rpp.append([r for r in reads if r])
    return graphs, rpp


def _case_short_reads(rng):
    seqs, edges = _random_graph(rng, max_nodes=5, max_len=20)
    reads = [_read_from_graph(rng, seqs, edges, read_len=rng.randint(3, 12),
                              indel=0.0) for _ in range(6)]
    return [_make_graph(seqs, edges)], [[r for r in reads if r]]


def _case_long_read(rng):
    # a deletion graph of ~600 columns and a 150 bp read drawn from it
    def seq(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    g = _make_graph(["X", seq(150), seq(300), seq(150), "X"],
                    [(0, 1), (1, 2), (1, 3), (2, 3), (3, 4)])
    alt = g.node_seq(1) + g.node_seq(3)
    ref = g.node_seq(1) + g.node_seq(2) + g.node_seq(3)
    reads = [alt[70:220], ref[300:450]]
    return [g], [reads]


#: (case, seed) pairs shared with the CUDA tests (test_cuda_fill.py)
#: and chip_smoke.py
ORACLE_CASES = [(_case_multi_pred, 11), (_case_empty_pairs, 12),
                (_case_short_reads, 13), (_case_long_read, 14)]
ORACLE_IDS = ["multi_pred", "empty_pairs", "short_reads",
              "read150_on_600_columns"]


@pytest.mark.parametrize("case,seed", ORACLE_CASES, ids=ORACLE_IDS)
def test_xla_fill_matches_oracle(case, seed):
    graphs, rpp = case(random.Random(seed))
    sw = PairedGraphSW(graphs)
    assert sw.engine == "xla"
    check_against_oracle(graphs, rpp, sw.score_pairs(rpp))


@pytest.mark.parametrize("platform,want", [("gpu", "cuda"), ("cpu", "xla"),
                                           ("rocm", None)])
def test_engine_choice(platform, want):
    if want is None:
        with pytest.raises(ValueError, match="no graph-SW engine"):
            select_engine(platform)
    else:
        assert select_engine(platform) == want == ENGINES[platform]


def test_unknown_engine_name_rejected():
    g = _make_graph(["ACGT", "TTGA"], [(0, 1)])
    with pytest.raises(ValueError, match="unknown graph-SW engine"):
        PairedGraphSW([g], engine="scan")


def test_pair_tables_padding_and_output_slicing():
    """Lanes pad per pair to tile multiples, tiles pad to the requested
    power-of-two budget with clen=0, and the fill returns one [4, B]
    block that slices back to 2n reads per orientation."""
    rng = random.Random(5150)
    graphs, rpp = [], []
    for n in (3, 0, 70):
        seqs, edges = _random_graph(rng, max_nodes=4, max_len=16)
        graphs.append(_make_graph(seqs, edges))
        rpp.append([_read_from_graph(rng, seqs, edges, read_len=12,
                                     indel=0.0) or "ACGT"
                    for _ in range(n)])
    tb = 32
    sw = PairedGraphSW(graphs, tile_batch=tb)
    a = sw.chunk_arrays[0]
    t = build_pair_tables(a, rpp, tb, tiles_to=16, bases_to=128)
    real_tiles = sum(pair_tiles(len(r), tb) for r in rpp)
    assert real_tiles == 2 * 1 + 0 + 2 * 5
    n_tiles = len(t["tile_event"])
    assert n_tiles == 16
    assert (t["tile_col_len"][real_tiles:] == 0).all()
    assert len(t["col_idx"]) == len(t["flip"]) == n_tiles * tb
    assert t["codes"].shape == (128, 32) and t["codes"].dtype == np.int8
    assert t["layout"][1] == ([0, 0, 0, 0], 0)
    out = np.asarray(paired_fill(
        a.packed_cols, a.pred_tables, t["tile_col_start"],
        t["tile_col_len"], t["tile_event"], t["codes"], t["lens"],
        t["vlens"], t["col_idx"], t["flip"], t["comp"], L_ev=t["l_ev"],
        N=a.n_max, P=a.p_max, M=t["m"], TB=tb, engine="xla"))
    assert out.shape == (4, n_tiles * tb) and out.dtype == np.int32
    # pad tiles never walk a column: zero score, no end cell
    assert (out[0, real_tiles * tb:] == 0).all()
    assert (out[1, real_tiles * tb:] == -1).all()
    got = sw.score_pairs(rpp)
    for reads, (f_out, r_out) in zip(rpp, got):
        assert all(len(x) == 2 * len(reads) for x in f_out + r_out)
    check_against_oracle(graphs, rpp, got)


def test_engine_report_accounting():
    """Per-dispatch observability: issued cells, lanes, device wait and
    the engine that ran."""
    rng = np.random.RandomState(3)
    seq = lambda n: "".join("ACGT"[i] for i in rng.randint(0, 4, n))
    g = SequenceGraph(["a", "b", "c"], [seq(60), seq(30), seq(60)])
    g.add_edge(0, 1)
    g.add_edge(0, 2)
    g.add_edge(1, 2)
    reads = [seq(40) for _ in range(5)]

    sw = PairedGraphSW([g])
    sw.score_pairs([reads])
    rep = sw.engine_report()
    assert rep["dispatches"] == 1
    assert rep["engine"] == "xla"
    # at least the real work: 4 orientations x reads x cols x stripe len
    a = sw.chunk_arrays[0]
    real = 2 * len(reads) * (a.col_len[0] + a.col_len[1]) * 48
    assert rep["cells"] >= real
    assert rep["lanes"] == 2 * 128
    assert rep["device_wait_s"] > 0
    assert rep["cells_per_wait_s"] > 0
    assert "vpu_util_est" not in rep


def test_multi_graph_arrays_pred_remap():
    """Each event's zero-state slot maps to the shared N_max slot and pad
    events carry all-zero-state predecessor rows."""
    g = _make_graph(["ACGT", "TT", "GGC"], [(0, 1), (0, 2), (1, 2)])
    a = MultiGraphArrays([g, g.reversed()], n_max=8, p_max=2, e_to=4)
    assert a.pred_tables.shape == (4, 8, 2)
    assert (a.pred_tables[2:] == 8).all()
    assert a.pred_tables.max() == 8
