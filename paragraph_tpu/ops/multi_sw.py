"""Multi-event paired graph-SW: many graphs, one device dispatch.

The production workload is thousands of small SV graphs, each with its own
read set (SURVEY.md §2.3: the reference farms them over a thread pool).
One dispatch scores a whole event batch: all events' graph columns are
concatenated into one stream, and every tile of TB read lanes is assigned
one event's column range, which it walks with its DP state kept per lane.
Node ids are event-local, so the boundary state stays [N_max+1] columns
per lane; predecessor tables stack per event.

Two fills implement the same semantics on the same tables:

- ``xla_fill``: plain ``jax.numpy``/``lax`` (a loop over the event-local
  column index). It is the engine on the CPU, the reference for the
  kernel, and what the kernel is timed against.
- ``cuda_fill`` (ops/cuda_sw.py, native/graph_sw_cuda.cu): the hand-written
  Hopper kernel, the engine on the GPU.

``select_engine`` picks one from the platform; there is no fallback.

DP formulation (both fills): the F column recurrence is solved in closed
form as a log2(M)-step shifted-max prefix scan along the read axis (valid
because gapO >= gapE; see align/gssw.py), and end tracking is a running
max of a packed word [ score | inverted column | inverted read row ]
(``pack_bits``), so gssw's tie-break order (max score, first strict
attainment column, min read row) reduces to one max per column.
"""
from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import numpy as np

from ..utils.jaxcfg import configure as _jax_configure
_jax_configure()

import jax
import jax.numpy as jnp

from ..graph.model import SequenceGraph
from .batched_sw import GraphArrays, encode_blob
from .cuda_sw import cuda_fill

_BIG = np.int32(2 ** 30)
DEFAULT_TB = 128

# Shape buckets: every production dispatch pads to these, so one compiled
# program serves a whole run (and, with the persistent compile cache,
# later runs). Padding is cheap: pad tiles carry clen=0 (their column loop
# never runs), pad events get all-zero-state predecessor tables, and pad
# columns/bases are plain memory. The buckets apply on the GPU only; CPU
# test runs use exact shapes.
TILE_BUDGET = 256          # tile floor per dispatch
PAIR_BUDGET = 48           # pairs per chunk -> pred_tables E = 96 fixed
COL_BUDGET = 49152         # graph columns per chunk
L_EV_FLOOR = 2048          # packed end-tracking column-bit budget
M_FLOOR = 160              # read-length stripe floor (150bp + bucket)

#: fill engine per JAX platform
ENGINES = {"gpu": "cuda", "cpu": "xla"}


def select_engine(platform: str) -> str:
    """The fill engine for a JAX platform: the CUDA kernel on the GPU, the
    plain XLA fill on the CPU. Any other platform is an error."""
    try:
        return ENGINES[platform]
    except KeyError:
        raise ValueError(
            f"no graph-SW engine for platform {platform!r}; "
            f"supported: {sorted(ENGINES)}") from None


def _bucket(x: int, m: int) -> int:
    return -(x // -m) * m


def _pow2_at_least(x: int, floor: int) -> int:
    v = max(1, floor)
    while v < x:
        v *= 2
    return v


def _bit_length(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def pack_bits(L: int, M: int, match: int):
    """Bit split for the packed end-cell tracking word:
    [ score | inverted column (col_bits) | inverted read row (j_bits) ].
    Returns (col_bits, j_bits), or None if scores could overflow the
    score bits (never the case for paragraph's match=1 scoring on short
    reads; callers assert)."""
    col_bits = _bit_length(L)
    j_bits = _bit_length(M)
    score_bits = 31 - col_bits - j_bits
    if score_bits < 1 or match * M >= (1 << score_bits):
        return None
    return col_bits, j_bits


class MultiGraphArrays:
    """Concatenated device arrays for a batch of graphs."""

    def __init__(self, graphs: Sequence[SequenceGraph],
                 prebuilt: Sequence[GraphArrays] = None,
                 n_max: int = 0, p_max: int = 0,
                 l_to: int = 0, e_to: int = 0):
        arrays = list(prebuilt) if prebuilt is not None else \
            [GraphArrays.build(g) for g in graphs]
        self.per_event = arrays
        self.n_max = max(n_max, max(a.num_nodes for a in arrays))
        self.p_max = max(p_max, max(a.pred_table.shape[1] for a in arrays))
        self.col_len = [len(a.ref_codes) for a in arrays]
        ends = np.cumsum([0] + self.col_len)
        self.col_start = ends[:-1].tolist()
        l_real = int(ends[-1])
        # pad column stream to a bucketed length for compile reuse; pad
        # the event axis with all-zero-state predecessor tables so
        # pred_tables keeps one shape regardless of chunk occupancy
        l_bucket = max(_bucket(max(1, l_real), 1024), l_to)
        e_total = max(len(arrays), e_to)

        def cat(parts, dtype, pad_val):
            out = np.full(l_bucket, pad_val, dtype)
            out[:l_real] = np.concatenate(parts)
            return out

        self.ref_codes = cat([a.ref_codes for a in arrays], np.int32, 4)
        self.col_node = cat([a.col_node for a in arrays], np.int32, 0)
        self.col_in_node = cat(
            [a.col_in_node for a in arrays], np.int32, 0)
        self.is_start = cat(
            [a.is_start.astype(np.int32) for a in arrays], np.int32, 0)
        self.is_last = cat(
            [a.is_last.astype(np.int32) for a in arrays], np.int32, 0)
        # one int32 per column, the only per-column word the fills read:
        # [ last(16) | start(15) | node id(14:3) | ref code(2:0) ]
        # (col_in_node stays host-only)
        assert self.n_max < (1 << 12)
        self.packed_cols = (self.ref_codes
                            | (self.col_node << 3)
                            | (self.is_start << 15)
                            | (self.is_last << 16)).astype(np.int32)
        pred_tables = np.full((e_total, self.n_max, self.p_max),
                              self.n_max, np.int32)
        for e, a in enumerate(arrays):
            pt = a.pred_table
            block = pred_tables[e, :pt.shape[0], :pt.shape[1]]
            np.copyto(block, pt)
            # remap each event's zero-state slot to the shared N_max slot
            block[pt == a.num_nodes] = self.n_max
        self.pred_tables = pred_tables  # [E, N_max, P_max]


def expand_orientations(base_codes, base_lens, base_vlens, col_idx, flip,
                        comp):
    """Per-lane read codes [B, M] from the uploaded forward reads.

    GraphAligner's 4-orientation protocol (fwd + revcomp vs the forward
    graph, their reversals vs the reversed graph) scores each read four
    times, but every variant is a transform of the forward read:
    revcomp = complement(per-read flip), reversal = per-read flip,
    revcomp-reversal = complement. So only the forward codes are uploaded
    ([Bb, M] int8) and each lane gathers its base read (col_idx), then
    flips and/or complements it. Row layout and stripe-pad rows match
    host-encoded variants exactly."""
    c = jnp.take(base_codes, col_idx.astype(jnp.int32), axis=0)
    c = c.astype(jnp.int32)  # [B, M]
    lens = jnp.take(base_lens, col_idx.astype(jnp.int32))
    vlens = jnp.take(base_vlens, col_idx.astype(jnp.int32))
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, c.shape[1]), 1)
    flip_idx = jnp.where(jj < lens[:, None], lens[:, None] - 1 - jj, jj)
    flipped = jnp.take_along_axis(c, flip_idx, axis=1)
    x = jnp.where(flip[:, None] != 0, flipped, c)
    x = jnp.where((comp[:, None] != 0) & (x < 4), 3 - x, x)
    return x, lens, vlens


def xla_fill(packed_cols, pred_tables, tile_col_start, tile_col_len,
             tile_event, x, lens, vlens, *, N: int, P: int, M: int,
             TB: int, col_bits: int, j_bits: int, gap_open: int,
             gap_extend: int, match: int, mismatch: int):
    """Plain-JAX paired multi-event fill: a loop over the event-local
    column index k; tile t reads its own column c0[t] + k (masked past
    clen[t]) and gathers its own predecessor boundary columns.

    x: [B, M] read codes (0-3 bases, 4 N, 5 stripe pad); lens/vlens [B].
    Returns [4, B] int32: best score, winning global column (-1 when the
    score is 0), end read row, and the multi-node-top-score flag
    (alignsEndAtMultNodes)."""
    B = x.shape[0]
    T = B // TB
    s1 = col_bits + j_bits
    lmask = (1 << col_bits) - 1
    jmask = (1 << j_bits) - 1
    gapE = jnp.int32(gap_extend)
    gOE = jnp.int32(gap_open - gap_extend)

    x = x.reshape(T, TB, M)
    lens3 = lens.reshape(T, TB, 1)
    vlens3 = vlens.reshape(T, TB, 1)
    jj = jax.lax.broadcasted_iota(jnp.int32, (1, 1, M), 2)
    jgap = jj * gapE
    gterm2 = jgap + gapE - gap_open
    jterm_m = jnp.where(jj < vlens3, jmask - jj, -_BIG)
    real = jj < lens3
    is_base = x < 4
    t_idx = jnp.arange(T)
    pred_ev = pred_tables[tile_event]  # [T, N, P]
    L = packed_cols.shape[0]

    def shift_down(v, s, fill):
        return jnp.pad(v[..., :-s], ((0, 0), (0, 0), (s, 0)),
                       constant_values=fill)

    def body(k, st):
        h, e, saved_h, saved_e, node_max, nodecol, best = st
        valid = k < tile_col_len
        pc = packed_cols[jnp.minimum(tile_col_start + k, L - 1)]
        ref_c = (pc & 7)[:, None, None]
        nid = (pc >> 3) & 0xFFF
        start = valid & ((pc & (1 << 15)) != 0)
        last = valid & ((pc & (1 << 16)) != 0)

        # node start: seed from the predecessors' boundary columns
        # (slot N is the all-zero state)
        preds = pred_ev[t_idx, nid]  # [T, P]
        seed_h = jnp.max(saved_h[t_idx[:, None], preds], axis=1)
        seed_e = jnp.max(saved_e[t_idx[:, None], preds], axis=1)
        st3 = start[:, None, None]
        h = jnp.where(st3, seed_h, h)
        e = jnp.where(st3, seed_e, e)
        nodecol = jnp.where(start[:, None], 0, nodecol)

        prof = jnp.where(
            ref_c < 4,
            jnp.where(x == ref_c, match, jnp.where(is_base, -mismatch, 0)),
            0)
        hp = jnp.maximum(jnp.maximum(shift_down(h, 1, 0) + prof, 0), e)
        g = hp + gterm2
        s = 1
        while s < M:
            g = jnp.maximum(g, shift_down(g, s, -_BIG))
            s *= 2
        f = jnp.maximum(shift_down(g, 1, -_BIG) - jgap, 0)
        h = jnp.maximum(hp, f)
        e = jnp.maximum(e, h - gOE) - gapE

        packed = (h << s1) + (((lmask - k) << j_bits) + jterm_m)
        best = jnp.where(valid[:, None],
                         jnp.maximum(best, jnp.max(packed, axis=2)), best)
        nodecol = jnp.maximum(
            nodecol, jnp.max(jnp.where(real, h, 0), axis=2))

        l3 = last[:, None, None]
        saved_h = saved_h.at[t_idx, nid].set(
            jnp.where(l3, h, saved_h[t_idx, nid]))
        saved_e = saved_e.at[t_idx, nid].set(
            jnp.where(l3, e, saved_e[t_idx, nid]))
        node_max = node_max.at[t_idx, nid].set(
            jnp.where(last[:, None], nodecol, node_max[t_idx, nid]))
        return h, e, saved_h, saved_e, node_max, nodecol, best

    zeros = jnp.zeros((T, TB, M), jnp.int32)
    state = (zeros, zeros,
             jnp.zeros((T, N + 1, TB, M), jnp.int32),
             jnp.zeros((T, N + 1, TB, M), jnp.int32),
             jnp.zeros((T, N, TB), jnp.int32),
             jnp.zeros((T, TB), jnp.int32),
             jnp.zeros((T, TB), jnp.int32))
    state = jax.lax.fori_loop(0, jnp.max(tile_col_len), body, state)
    node_max, best = state[4], state[6]

    cur_max = best >> s1
    end_col = tile_col_start[:, None] + (lmask - ((best >> j_bits) & lmask))
    first_j = jmask - (best & jmask)
    n_top = jnp.sum((node_max == cur_max[:, None, :]).astype(jnp.int32),
                    axis=1)
    zero = cur_max == 0
    out = jnp.stack([
        cur_max,
        jnp.where(zero, -1, end_col),
        jnp.where(zero, 0, jnp.minimum(first_j, lens.reshape(T, TB) - 1)),
        (n_top > 1).astype(jnp.int32),
    ])
    return out.reshape(4, B)


#: fill implementation per engine name
FILLS = {"cuda": cuda_fill, "xla": xla_fill}


def resolve_engine(platform: str, engine: str = None) -> str:
    """`engine` if given (checked), else the platform's engine."""
    engine = engine or select_engine(platform)
    if engine not in FILLS:
        raise ValueError(f"unknown graph-SW engine {engine!r}")
    return engine


@partial(jax.jit,
         static_argnames=("L_ev", "N", "P", "M", "TB", "engine", "gap_open",
                          "gap_extend", "match", "mismatch"))
def paired_fill(packed_cols, pred_tables, tile_col_start, tile_col_len,
                tile_event, base_codes, base_lens, base_vlens, col_idx,
                flip, comp, *, L_ev: int, N: int, P: int, M: int, TB: int,
                engine: str, gap_open: int = 6, gap_extend: int = 1,
                match: int = 1, mismatch: int = 4):
    """One paired dispatch: derive every lane's read orientation on device
    (expand_orientations), then run the chosen fill. Returns one [4, B]
    int32 block so the caller pays a single host fetch."""
    x, lens, vlens = expand_orientations(base_codes, base_lens, base_vlens,
                                         col_idx, flip, comp)
    assert x.shape[0] % TB == 0
    bits = pack_bits(L_ev, M, match)
    assert bits is not None, "scores overflow packed tracking"
    return FILLS[engine](
        packed_cols, pred_tables, tile_col_start, tile_col_len, tile_event,
        x, lens, vlens, N=N, P=P, M=M, TB=TB, col_bits=bits[0],
        j_bits=bits[1], gap_open=gap_open, gap_extend=gap_extend,
        match=match, mismatch=mismatch)


def pair_tiles(n: int, tb: int) -> int:
    """Tiles a pair with n reads contributes under the packed layout: two
    blocks (fwd graph, rev graph) of bucket(2n, tb) lanes each."""
    return 2 * (_bucket(2 * n, tb) // tb) if n else 0


def pair_norm(reads) -> Tuple[bytes, np.ndarray]:
    """Normalize one pair's read set to (blob, lens) encoded form.

    Accepts either a list of (mixed-case) read strings or a pre-built
    (upper-case bytes blob, int32 lengths) tuple — the form the
    pipelined orchestrator's extraction workers ship so the parent never
    materialises per-read Python strings on the dispatch critical path."""
    if isinstance(reads, tuple):
        blob, lens = reads
        return blob, np.asarray(lens, np.int32)
    lens = np.fromiter((len(r) for r in reads), np.int32, count=len(reads))
    return "".join(reads).upper().encode(), lens


def pair_count(reads) -> int:
    return len(reads[1]) if isinstance(reads, tuple) else len(reads)


def pair_max_len(reads) -> int:
    if isinstance(reads, tuple):
        lens = reads[1]
        return int(np.max(lens)) if len(lens) else 0
    return max((len(r) for r in reads), default=0)


def build_pair_tables(a: MultiGraphArrays, reads_per_pair, tb: int,
                      pad_to: int = 0, tiles_to: int = 0, bases_to: int = 0,
                      l_ev_floor: int = 0):
    """Host-side table construction for one paired dispatch: read encode,
    orientation expansion tables (col_idx/flip/comp), and per-tile
    (event, column-range) assignments. Shared by the single-device
    PairedGraphSW and the mesh-sharded scorer (parallel/distributed.py),
    which pads tiles_to/bases_to so every shard has identical shapes.

    Lane layout packs the two orientations that walk the same graph into
    shared tiles — [fwd | revcomp] vs the forward graph, [rev | comp] vs
    the reversed graph — since flip/comp selection is per-lane and only
    the event id is per-tile. Padding each pair to tile granularity
    twice (instead of four times, one per orientation) halves the lane
    padding for small read sets.

    Pairs with no reads contribute zero tiles/bases, and pad tiles carry
    clen=0 so their column loop never executes — tile padding costs only
    the per-tile state init, not a graph re-scan.
    """
    base_blobs: List[bytes] = []
    base_lens: List[np.ndarray] = []
    n_bases = 0
    col_chunks: List[np.ndarray] = []
    flip_chunks: List[np.ndarray] = []
    comp_chunks: List[np.ndarray] = []
    tile_event: List[int] = []
    tile_col_start: List[int] = []
    tile_col_len: List[int] = []
    layout = []  # (block_offsets[4], n) per pair
    lane_count = 0
    max_len = 1
    for j, reads in enumerate(reads_per_pair):
        n = pair_count(reads)
        if n == 0:
            layout.append(([0, 0, 0, 0], 0))
            continue
        base_off = n_bases
        blob, lens_j = pair_norm(reads)
        base_blobs.append(blob)
        base_lens.append(lens_j)
        n_bases += n
        max_len = max(max_len, int(lens_j.max()))
        lanes = _bucket(2 * n, tb)
        idx = np.arange(base_off, base_off + n, dtype=np.int32)
        lane_cols = np.concatenate(
            [idx, idx, np.full(lanes - 2 * n, base_off, np.int32)])
        offsets = []
        # per-pair blocks: [fwd | revcomp] vs fwd graph, then
        # [rev | comp] vs rev graph; offsets = [o_f, o_rc, o_rev, o_cp]
        for ev_local, (f0, c0), (f1, c1) in (
                (2 * j, (0, 0), (1, 1)), (2 * j + 1, (1, 0), (0, 1))):
            offsets.append(lane_count)
            offsets.append(lane_count + n)
            col_chunks.append(lane_cols)
            fl = np.zeros(lanes, np.int8)
            cp = np.zeros(lanes, np.int8)
            fl[:n] = f0
            fl[n:2 * n] = f1
            cp[:n] = c0
            cp[n:2 * n] = c1
            flip_chunks.append(fl)
            comp_chunks.append(cp)
            tile_event.extend([ev_local] * (lanes // tb))
            tile_col_start.extend([a.col_start[ev_local]] * (lanes // tb))
            tile_col_len.extend([a.col_len[ev_local]] * (lanes // tb))
            lane_count += lanes
        layout.append((offsets, n))
    # bucket tiles (pad tiles are free: clen=0 skips the column loop)
    n_tiles = len(tile_event)
    t_bucket = max(1, tiles_to)
    while t_bucket < n_tiles:
        t_bucket *= 2
    pad_tiles = t_bucket - n_tiles
    if pad_tiles:
        tile_event.extend([0] * pad_tiles)
        tile_col_start.extend([0] * pad_tiles)
        tile_col_len.extend([0] * pad_tiles)
        col_chunks.append(np.zeros(pad_tiles * tb, np.int32))
        flip_chunks.append(np.zeros(pad_tiles * tb, np.int8))
        comp_chunks.append(np.zeros(pad_tiles * tb, np.int8))
    if not n_bases:
        base_blobs.append(b"A")
        base_lens.append(np.ones(1, np.int32))
        n_bases = 1
    if bases_to:
        assert bases_to >= n_bases
        pad_n = bases_to - n_bases
        if pad_n:
            base_blobs.append(b"A" * pad_n)
            base_lens.append(np.ones(pad_n, np.int32))

    pad_to = max(pad_to, _bucket(max_len, 32))
    codes, lens, vlens = encode_blob(
        b"".join(base_blobs), np.concatenate(base_lens), pad_to)
    # the lane->base index is uploaded every dispatch: int16 halves it
    # (base counts are int16-safe below 32768)
    col_idx = np.concatenate(col_chunks)
    if codes.shape[0] <= 32767:
        col_idx = col_idx.astype(np.int16)
    l_ev = max(_bucket(max(a.col_len), 256), l_ev_floor)
    assert pack_bits(l_ev, codes.shape[1], 1) is not None
    return {
        "tile_col_start": np.asarray(tile_col_start, np.int32),
        "tile_col_len": np.asarray(tile_col_len, np.int32),
        "tile_event": np.asarray(tile_event, np.int32),
        "codes": codes.astype(np.int8),
        "lens": lens.astype(np.int32),
        "vlens": vlens.astype(np.int32),
        "col_idx": col_idx,
        "flip": np.concatenate(flip_chunks),
        "comp": np.concatenate(comp_chunks),
        "l_ev": l_ev,
        "m": codes.shape[1],
        "layout": layout,
    }


#: per-dispatch tables in paired_fill's argument order
TABLE_KEYS = ("tile_col_start", "tile_col_len", "tile_event", "codes",
              "lens", "vlens", "col_idx", "flip", "comp")


def slice_pair_outputs(a: MultiGraphArrays, vals: np.ndarray, layout,
                       idxs, results) -> None:
    """Map one fetched [4, B] output block back to per-pair (f_out, r_out)
    5-tuples, resolving global columns to (node, in-node offset)."""
    score, end_col, end_read, multi = vals
    valid = end_col >= 0
    safe_col = np.where(valid, end_col, 0)
    end_node = np.where(valid, a.col_node[safe_col], 0).astype(np.int32)
    end_ref = np.where(valid, a.col_in_node[safe_col], -1).astype(np.int32)
    full = (score, end_node, end_ref, end_read, multi)
    for (offsets, n), p in zip(layout, idxs):
        o_f, o_rc, o_rev, o_cp = offsets
        f_out = tuple(
            np.concatenate([x[o_f:o_f + n], x[o_rc:o_rc + n]])
            for x in full)
        r_out = tuple(
            np.concatenate([x[o_rev:o_rev + n], x[o_cp:o_cp + n]])
            for x in full)
        results[p] = (f_out, r_out)


class PairedGraphSW:
    """Device scorer for the full 4-orientation protocol over an event
    batch: one pair = (graph, its reads); the reversed graph and all read
    orientation variants are derived internally (the variants on device,
    see expand_orientations). Graph column streams and predecessor tables
    are uploaded once at construction and reused by every dispatch.

    score_pairs() returns, per pair, two 5-tuples: f_out for [fwd +
    revcomp] reads vs the forward graph and r_out for their reversals vs
    the reversed graph.

    `engine` defaults to select_engine() of the default device's platform.
    """

    def __init__(self, graphs: Sequence[SequenceGraph],
                 tile_batch: int = DEFAULT_TB, engine: str = None,
                 col_budget: int = COL_BUDGET):
        platform = jax.devices()[0].platform
        self.engine = resolve_engine(platform, engine)
        # shape buckets only where compiled shapes are worth reusing
        self.bucketed = platform != "cpu"
        #: per-run observability: every dispatch's issued work and the
        #: host-blocking device wait
        self.stats = {"dispatches": 0, "cells": 0, "lanes": 0,
                      "device_wait_s": 0.0, "dispatch_host_s": 0.0}
        built = {}

        def build(g):
            key = id(g)
            if key not in built:
                built[key] = (GraphArrays.build(g),
                              GraphArrays.build(g.reversed()))
            return built[key]

        pair_gas = [build(g) for g in graphs]
        # bucket the static kernel parameters so every chunk of every run
        # with similarly-shaped graphs reuses ONE compiled program
        self.n_max = _bucket(
            max(max(f.num_nodes, r.num_nodes) for f, r in pair_gas), 8)
        self.p_max = _pow2_at_least(
            max(max(f.pred_table.shape[1], r.pred_table.shape[1])
                for f, r in pair_gas), 2)
        self.tile_batch = tile_batch
        # Chunk rule: a dispatch holds at most PAIR_BUDGET pairs and
        # col_budget graph columns. Neither fill has a capacity limit
        # here (both read the column stream and the predecessor tables
        # from device memory, and the CUDA kernel's boundary-column
        # scratch scales with lanes, not columns); the budgets fix the
        # compiled shapes (E = 2 * PAIR_BUDGET predecessor tables, a
        # column stream bucketed to col_budget) and make one
        # single-sample pipeline round exactly one dispatch. Per-pair
        # outputs do not depend on the chunking.
        pair_budget = PAIR_BUDGET
        self.e_uni = 2 * pair_budget
        self.chunk_pairs: List[List[int]] = []
        self.chunk_arrays: List[MultiGraphArrays] = []
        cur: List[int] = []
        cur_cols = 0
        for i, (fa, ra) in enumerate(pair_gas):
            cols = len(fa.ref_codes) + len(ra.ref_codes)
            if cur and (cur_cols + cols > col_budget
                        or len(cur) >= pair_budget):
                self.chunk_pairs.append(cur)
                cur, cur_cols = [], 0
            cur.append(i)
            cur_cols += cols
        if cur:
            self.chunk_pairs.append(cur)
        max_chunk_cols = max(
            sum(len(pair_gas[i][0].ref_codes) + len(pair_gas[i][1].ref_codes)
                for i in idxs) for idxs in self.chunk_pairs)
        self.l_uni = _bucket(max(col_budget, max_chunk_cols), 1024)
        self.l_ev = max(L_EV_FLOOR, _bucket(
            max(max(len(f.ref_codes), len(r.ref_codes))
                for f, r in pair_gas), 256))
        self._chunk_dev = []
        for idxs in self.chunk_pairs:
            prebuilt = []
            for i in idxs:
                prebuilt.extend(pair_gas[i])
            a = MultiGraphArrays(None, prebuilt=prebuilt,
                                 n_max=self.n_max, p_max=self.p_max,
                                 l_to=self.l_uni, e_to=self.e_uni)
            self.chunk_arrays.append(a)
            # resident device copies of the graph tables
            self._chunk_dev.append(jax.device_put((
                a.packed_cols, a.pred_tables)))

    def prepare_dispatch(self, chunk_i: int, reads_per_pair, pad_to: int):
        """Build and upload one dispatch's tables. Returns (device args,
        static kwargs, host tables) such that paired_fill(*args,
        **statics) is the dispatch."""
        import time as _time

        t0 = _time.perf_counter()
        tb = self.tile_batch
        a = self.chunk_arrays[chunk_i]
        # tile/base budgets: fixed floor, pow2 growth for oversize read
        # sets — at most a handful of distinct compiled shapes ever
        tiles_raw = sum(pair_tiles(pair_count(r), tb)
                        for r in reads_per_pair)
        tiles_to = _pow2_at_least(
            tiles_raw, TILE_BUDGET if self.bucketed else 1)
        # the base-codes matrix is the bulk of the per-dispatch upload
        # ([Bb, M] int8); bucket its row count to the real read total,
        # not to the (much larger) padded lane budget — pad tiles gather
        # base row 0, so any Bb >= n_reads is valid
        n_reads_real = sum(pair_count(r) for r in reads_per_pair)
        bases_to = min(_pow2_at_least(
            n_reads_real, 1024 if self.bucketed else 1), tiles_to * tb // 4)
        t = build_pair_tables(a, reads_per_pair, tb, pad_to,
                              tiles_to=tiles_to, bases_to=bases_to,
                              l_ev_floor=self.l_ev)
        self.stats["tables_s"] = self.stats.get("tables_s", 0.0) + (
            _time.perf_counter() - t0)
        t0 = _time.perf_counter()
        tables = jax.device_put(tuple(t[k] for k in TABLE_KEYS))
        self.stats["put_s"] = self.stats.get("put_s", 0.0) + (
            _time.perf_counter() - t0)
        statics = dict(L_ev=t["l_ev"], N=a.n_max, P=a.p_max, M=t["m"],
                       TB=tb, engine=self.engine)
        return (*self._chunk_dev[chunk_i], *tables), statics, t

    def _dispatch(self, chunk_i: int, reads_per_pair, pad_to: int):
        import time as _time

        t_host = _time.perf_counter()
        args, statics, t = self.prepare_dispatch(chunk_i, reads_per_pair,
                                                 pad_to)
        t0 = _time.perf_counter()
        out = paired_fill(*args, **statics)
        self.stats["call_s"] = self.stats.get("call_s", 0.0) + (
            _time.perf_counter() - t0)
        self.stats["dispatches"] += 1
        self.stats["cells"] += int(
            t["tile_col_len"].astype(np.int64).sum()) * statics["TB"] * t["m"]
        self.stats["lanes"] += len(t["col_idx"])
        self.stats["dispatch_host_s"] += _time.perf_counter() - t_host
        return out, t["layout"]

    def pad_rows(self, reads_per_pair, pad_to: int = 0) -> int:
        """Read-row count M for a batch: the stripe bucket of its longest
        read, at least M_FLOOR where shapes are bucketed."""
        max_len = max((pair_max_len(r) for r in reads_per_pair),
                      default=1)
        m_floor = M_FLOOR if self.bucketed else 32
        return max(pad_to, m_floor, _bucket(max_len, 32))

    def score_pairs_device(self, reads_per_pair: Sequence[List[str]],
                           pad_to: int = 0):
        """Dispatch all chunks without fetching; callers can keep several
        batches in flight and finalize_pairs() them later."""
        pad_to = self.pad_rows(reads_per_pair, pad_to)
        pending = []
        for chunk_i, idxs in enumerate(self.chunk_pairs):
            out, layout = self._dispatch(
                chunk_i, [reads_per_pair[p] for p in idxs], pad_to)
            pending.append((chunk_i, idxs, out, layout))
        return pending, len(reads_per_pair)

    def score_pairs(self, reads_per_pair: Sequence[List[str]],
                    pad_to: int = 0):
        """Returns per pair (f_out, r_out); each is a (score, end_node,
        end_ref, end_read, multi) tuple of np arrays over 2n reads in the
        [fwd + revcomp] / [their reversals] order."""
        return self.finalize_pairs(
            self.score_pairs_device(reads_per_pair, pad_to))

    def finalize_pairs(self, handle):
        import time as _time

        pending, n_pairs = handle
        results = [None] * n_pairs
        t0 = _time.perf_counter()
        if len(pending) > 1 and len(
                {p[2].shape for p in pending}) == 1:
            stacked = np.asarray(jnp.stack([p[2] for p in pending]))
            vals_list = list(stacked)
        else:
            vals_list = [np.asarray(p[2]) for p in pending]
        self.stats["device_wait_s"] += _time.perf_counter() - t0
        for (chunk_i, idxs, out, layout), vals in zip(pending, vals_list):
            a = self.chunk_arrays[chunk_i]
            slice_pair_outputs(a, vals, layout, idxs, results)
        return results

    def engine_report(self) -> dict:
        """Per-run fill counts (dispatches, issued DP cells, lanes), the
        engine that ran, and the host-blocking device wait. The wait is a
        LOWER bound on device time when finalize overlaps host work, so
        cells_per_wait_s is an upper bound on the fill's throughput."""
        wait = self.stats["device_wait_s"]
        return {
            **self.stats,
            "engine": self.engine,
            "cells_per_wait_s": self.stats["cells"] / wait if wait > 0
            else 0.0,
        }
