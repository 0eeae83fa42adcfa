"""Batched graph Smith-Waterman scoring over one graph (JAX/XLA).

A batched re-design of the gssw fill (SURVEY.md §7.3): instead of one
read × one node at a time with SSE stripes, thousands of reads are scored
simultaneously as a `lax.scan` over the concatenated reference columns of
all graph nodes in topological order. Each scan step is elementwise
work on [batch, read_len] tiles:

  H'     = max(0, H_prev(shifted) + profile, E)
  F      = max-plus prefix scan of H' along the read axis
           (exact because gap_open >= gap_extend, so F never chains off
           F-derived H values — see align/gssw.py fill derivation)
  H      = max(H', F)
  E_next = max(0, E - gapE, H - gapO)

Cross-node seeding (gssw_create_seed semantics) is handled by saving each
node's boundary state (last H column + outgoing E) into a carry buffer and
taking the elementwise max over predecessor entries at node-start columns.

Outputs per read: best score, end cell (node / ref offset / read offset,
with gssw's first-strict-attainment and min-read-position tie-breaks), and
the multi-node-top-score flag that drives MAPQ (alignsEndAtMultNodes,
GraphAligner.cpp:170-212). Semantics (incl. striped padding-lane echoes)
are cell-exact against the scalar oracle in align/gssw.py, which is itself
differentially validated against the original gssw C library.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Tuple

import numpy as np

from ..utils.jaxcfg import configure as _jax_configure
_jax_configure()

import jax
import jax.numpy as jnp

from ..graph.model import SequenceGraph

_NT = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _NT[ord(_c)] = _i

_BIG = np.int32(2 ** 30)


@dataclass(frozen=True)
class GraphArrays:
    """Device-friendly array representation of one sequence graph.

    The host↔device contract (SURVEY.md §7.2): padded/concatenated node
    sequences with per-column node ids and a dense predecessor table.
    """

    ref_codes: np.ndarray  # int32[L] base classes of concatenated nodes
    col_node: np.ndarray  # int32[L] node id per column
    col_in_node: np.ndarray  # int32[L] column offset within node
    is_start: np.ndarray  # bool[L]
    is_last: np.ndarray  # bool[L]
    pred_table: np.ndarray  # int32[N, P]; value N = "zero state" slot
    num_nodes: int

    @classmethod
    def build(cls, graph: SequenceGraph, bucket: bool = True
              ) -> "GraphArrays":
        """Build device arrays; with bucket=True, pad columns/nodes/preds
        to standard sizes so XLA compiles are shared across graphs.

        Padding appends disconnected fake nodes whose columns score 0
        against everything; they cannot affect scores, end cells, or (for
        nonzero alignments) the uniqueness count.
        """
        n_real = graph.num_nodes
        seqs = [graph.node_seq(nid).upper() for nid in range(n_real)]
        lens = np.fromiter((len(s) for s in seqs), np.int64, count=n_real)
        if n_real and int(lens.min()) == 0:
            raise ValueError(
                f"empty node sequence for node {int(lens.argmin())}")
        preds = [graph.predecessors(i) for i in range(n_real)]
        max_pred = max((len(p) for p in preds), default=1) or 1
        l_real = int(lens.sum())

        if bucket:
            n_bucket = -((n_real + 1) // -4) * 4
            n_fake = n_bucket - n_real
            p_bucket = -(max_pred // -2) * 2
            l_bucket = -((l_real + n_fake) // -64) * 64
        else:
            n_bucket = n_real
            n_fake = 0
            p_bucket = max_pred
            l_bucket = l_real

        pred_table = np.full((n_bucket, p_bucket), n_bucket, dtype=np.int32)
        for nid, plist in enumerate(preds):
            pred_table[nid, :len(plist)] = plist

        # fake filler nodes: first n_fake-1 are single columns, the last
        # absorbs the remaining padding
        if n_fake:
            pad_cols = l_bucket - l_real
            fake_lens = [1] * (n_fake - 1) + [pad_cols - (n_fake - 1)]
            all_lens = np.concatenate([lens, fake_lens]).astype(np.int64)
        else:
            all_lens = lens

        # vectorized column-stream construction (this runs per event on
        # the dispatch critical path)
        L = int(all_lens.sum())
        col_node = np.repeat(
            np.arange(len(all_lens), dtype=np.int32), all_lens)
        starts = np.zeros(len(all_lens), np.int64)
        np.cumsum(all_lens[:-1], out=starts[1:])
        col_in_node = (np.arange(L, dtype=np.int64)
                       - starts[col_node]).astype(np.int32)
        is_start = col_in_node == 0
        is_last = np.zeros(L, bool)
        is_last[np.cumsum(all_lens) - 1] = True
        ref_codes = np.full(L, 4, np.int32)  # fake cols: 'N' class
        if l_real:
            data = np.frombuffer("".join(seqs).encode(), np.uint8)
            ref_codes[:l_real] = _NT[data]

        return cls(
            ref_codes=ref_codes,
            col_node=col_node,
            col_in_node=col_in_node,
            is_start=is_start,
            is_last=is_last,
            pred_table=pred_table,
            num_nodes=n_bucket,
        )


def encode_reads(reads: List[str], pad_to: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode reads to code matrix + real/striped-pad lengths.

    Striped padding (gssw_qP_byte, gssw.c:78-97) rounds each read up to
    16-lane stripes; lanes in [len, 16*ceil(len/16)) behave as score-0
    positions and must be modelled for end/uniqueness parity.
    """
    n = len(reads)
    lens = np.fromiter((len(r) for r in reads), np.int32, count=n)
    max_len = int(lens.max()) if n else 1
    m = max(pad_to, ((max_len + 15) // 16) * 16)
    codes = np.full((n, m), 5, dtype=np.int32)  # 5 = pad class
    if n:
        # one pass over the concatenated bytes instead of a Python loop
        # per read (the encode is on the per-dispatch critical path)
        data = np.frombuffer("".join(reads).upper().encode(), np.uint8)
        if (lens == lens[0]).all():  # uniform-length fast path
            codes[:, :lens[0]] = _NT[data].reshape(n, lens[0])
        else:
            rows = np.repeat(np.arange(n, dtype=np.int64), lens)
            starts = np.concatenate(
                ([0], np.cumsum(lens[:-1], dtype=np.int64)))
            offs = np.arange(len(data), dtype=np.int64) - starts[rows]
            codes[rows, offs] = _NT[data]
    vlens = ((lens + 15) // 16) * 16
    return codes, lens, vlens.astype(np.int32)


def encode_blob(blob: bytes, lens: np.ndarray, pad_to: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """encode_reads for pre-concatenated UPPER-CASE read bases.

    The pipelined orchestrator's extraction workers ship each sample's
    reads as one bytes blob + length vector (see
    pipeline/parallel_grmpy.py::_extract_event); encoding straight from
    that form skips the decode → per-read str slice → re-join round
    trip that used to dominate dispatch host time. Same output contract
    as encode_reads (codes matrix with pad class 5, real lens, striped
    vlens)."""
    lens = np.asarray(lens, np.int32)
    n = len(lens)
    max_len = int(lens.max()) if n else 1
    m = max(pad_to, ((max_len + 15) // 16) * 16)
    codes = np.full((n, m), 5, dtype=np.int32)
    if n:
        data = np.frombuffer(blob, np.uint8)
        if (lens == lens[0]).all():
            codes[:, :lens[0]] = _NT[data].reshape(n, lens[0])
        else:
            rows = np.repeat(np.arange(n, dtype=np.int64), lens)
            starts = np.concatenate(
                ([0], np.cumsum(lens[:-1], dtype=np.int64)))
            offs = np.arange(len(data), dtype=np.int64) - starts[rows]
            codes[rows, offs] = _NT[data]
    vlens = ((lens + 15) // 16) * 16
    return codes, lens, vlens.astype(np.int32)


@partial(jax.jit, static_argnames=("num_nodes", "gap_open", "gap_extend",
                                   "match", "mismatch"))
def _batched_fill(ref_codes, col_node, col_in_node, is_start, is_last,
                  pred_table, read_codes, read_lens, read_vlens,
                  num_nodes: int, gap_open: int = 6, gap_extend: int = 1,
                  match: int = 1, mismatch: int = 4):
    B, M = read_codes.shape
    N = num_nodes
    gapO = jnp.int32(gap_open)
    gapE = jnp.int32(gap_extend)

    # score lookup: [5 ref classes, 6 read classes] (class 5 = stripe pad)
    mat = np.zeros((5, 6), dtype=np.int32)
    for l in range(4):
        for m2 in range(4):
            mat[l, m2] = match if l == m2 else -mismatch
    mat_j = jnp.asarray(mat)
    # profile per ref class: [5, B, M]
    prof_all = mat_j[:, read_codes]

    jj = jax.lax.broadcasted_iota(jnp.int32, (B, M), 1)
    real_mask = jj < read_lens[:, None]  # j < readLen
    stripe_mask = jj < read_vlens[:, None]  # j < 16*segLen

    def step(carry, xs):
        (H_prev, E_col, saved_H, saved_E, node_max_real, cur_max,
         end_node, end_ref, end_read) = carry
        ref_code, node_id, col_off, start_f, last_f = xs

        # node-start seeding: max over predecessors' saved boundary states
        pred_ids = jax.lax.dynamic_index_in_dim(
            pred_table, node_id, axis=0, keepdims=False)  # [P]
        seed_H = jnp.max(saved_H[pred_ids], axis=0)
        seed_E = jnp.max(saved_E[pred_ids], axis=0)
        H_prev = jnp.where(start_f, seed_H, H_prev)
        E_col = jnp.where(start_f, seed_E, E_col)

        prof = jax.lax.dynamic_index_in_dim(
            prof_all, ref_code, axis=0, keepdims=False)  # [B, M]
        diag = jnp.pad(H_prev[:, :-1], ((0, 0), (1, 0)))
        hp = jnp.maximum(diag + prof, 0)
        hp = jnp.maximum(hp, E_col)
        # F scan: F_j = max(0, cummax_k<j (hp_k - gapO + (k+1)*gapE) - j*gapE)
        A = hp - gapO + (jj + 1) * gapE
        G = jax.lax.associative_scan(jnp.maximum, A, axis=1)
        F = jnp.maximum(
            jnp.pad(G[:, :-1], ((0, 0), (1, 0)),
                    constant_values=-_BIG) - jj * gapE, 0)
        H = jnp.maximum(hp, F)
        E_next = jnp.maximum(jnp.maximum(E_col - gapE, H - gapO), 0)

        # boundary state save at node-end columns
        upd_H = jax.lax.dynamic_update_index_in_dim(
            saved_H, H, node_id, axis=0)
        upd_E = jax.lax.dynamic_update_index_in_dim(
            saved_E, E_next, node_id, axis=0)
        saved_H = jnp.where(last_f, upd_H, saved_H)
        saved_E = jnp.where(last_f, upd_E, saved_E)

        # column maxima: stripe-masked for end tracking, real-masked for
        # the uniqueness count (alignsEndAtMultNodes scans col < readLen)
        H_stripe = jnp.where(stripe_mask, H, 0)
        H_real = jnp.where(real_mask, H, 0)
        col_max = jnp.max(H_stripe, axis=1)  # [B]
        col_max_real = jnp.max(H_real, axis=1)

        nm = jax.lax.dynamic_index_in_dim(
            node_max_real, node_id, axis=1, keepdims=False)
        node_max_real = jax.lax.dynamic_update_index_in_dim(
            node_max_real, jnp.maximum(nm, col_max_real), node_id, axis=1)

        upd = col_max > cur_max
        first_j = jnp.min(
            jnp.where(jnp.logical_and(H_stripe == col_max[:, None],
                                      stripe_mask), jj, _BIG), axis=1)
        cand_read = jnp.minimum(first_j, read_lens - 1)
        cur_max = jnp.where(upd, col_max, cur_max)
        end_node = jnp.where(upd, node_id, end_node)
        end_ref = jnp.where(upd, col_off, end_ref)
        end_read = jnp.where(upd, cand_read, end_read)

        carry = (H, E_next, saved_H, saved_E, node_max_real, cur_max,
                 end_node, end_ref, end_read)
        return carry, None

    init = (
        jnp.zeros((B, M), jnp.int32),  # H_prev
        jnp.zeros((B, M), jnp.int32),  # E_col
        jnp.zeros((N + 1, B, M), jnp.int32),  # saved_H (slot N = zeros)
        jnp.zeros((N + 1, B, M), jnp.int32),  # saved_E
        jnp.zeros((B, N), jnp.int32),  # node_max_real
        jnp.zeros((B,), jnp.int32),  # cur_max
        jnp.zeros((B,), jnp.int32),  # end_node
        jnp.full((B,), -1, jnp.int32),  # end_ref
        read_lens - 1,  # end_read
    )
    xs = (ref_codes, col_node, col_in_node,
          is_start.astype(jnp.bool_), is_last.astype(jnp.bool_))
    carry, _ = jax.lax.scan(step, init, xs)
    (_, _, _, _, node_max_real, cur_max, end_node, end_ref, end_read) = carry

    multi = jnp.sum(
        (node_max_real == cur_max[:, None]).astype(jnp.int32), axis=1) > 1
    # zero-length reads / all-zero fills: end_read = 0 when readLen > 1
    # (gssw scans its zeroed pvHmax buffer, gssw.c:445-454)
    zero_fill = cur_max == 0
    end_read = jnp.where(
        jnp.logical_and(zero_fill, read_lens > 1),
        jnp.zeros_like(end_read), end_read)
    end_node = jnp.where(zero_fill, jnp.zeros_like(end_node), end_node)
    end_ref = jnp.where(zero_fill, jnp.full_like(end_ref, -1), end_ref)
    return cur_max, end_node, end_ref, end_read, multi, node_max_real


class BatchedGraphSW:
    """Batched scorer over one graph (all reads at once)."""

    def __init__(self, graph: SequenceGraph, match=1, mismatch=4,
                 gap_open=6, gap_extend=1):
        self.graph = graph
        self.arrays = GraphArrays.build(graph)
        self.match = match
        self.mismatch = mismatch
        self.gap_open = gap_open
        self.gap_extend = gap_extend

    def score(self, reads: List[str], pad_to: int = 0):
        """Score a batch of reads; returns numpy arrays
        (score, end_node, end_ref, end_read, multi).

        The batch is padded to a power-of-two size (dummy 1-base reads)
        and the read axis to a multiple of 32 so XLA compiles are reused
        across calls.
        """
        n_real = len(reads)
        b_bucket = 8
        while b_bucket < n_real:
            b_bucket *= 2
        reads = list(reads) + ["A"] * (b_bucket - n_real)
        max_len = max(len(r) for r in reads)
        pad_to = max(pad_to, -(max_len // -32) * 32)
        codes, lens, vlens = encode_reads(reads, pad_to)
        a = self.arrays
        out = _batched_fill(
            jnp.asarray(a.ref_codes), jnp.asarray(a.col_node),
            jnp.asarray(a.col_in_node), jnp.asarray(a.is_start),
            jnp.asarray(a.is_last), jnp.asarray(a.pred_table),
            jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(vlens),
            num_nodes=a.num_nodes, gap_open=self.gap_open,
            gap_extend=self.gap_extend, match=self.match,
            mismatch=self.mismatch)
        return tuple(np.asarray(x)[:n_real] for x in out[:5])
