"""Mesh-sharded event scoring: the production scorer on >1 device.

Replaces grmpy's thread pool over (sample x graph)
(/root/reference/src/c++/lib/grmpy/Workflow.cpp:224-231): (graph, reads)
pairs are partitioned across the devices of a flat 1-D
``jax.sharding.Mesh`` and one ``shard_map``-wrapped jit runs the paired
fill (ops/multi_sw.py paired_fill, with the platform's engine) on every
device simultaneously — per-shard graph column streams, predecessor
tables, and read batches are just sharded *data*, so a single compiled
program serves all shards. Event sharding needs no collectives (events are
independent, exactly like the reference's pool); read-level
data-parallel count merging with psum lives in parallel/mesh.py.

All shards are padded to identical shapes (columns, events, tiles, base
reads) so the SPMD program is shape-uniform; rounds of S slots reuse the
same compilation.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils.jaxcfg import configure as _jax_configure
_jax_configure()

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph.model import SequenceGraph
from ..ops.batched_sw import GraphArrays
from ..ops.multi_sw import (COL_BUDGET, DEFAULT_TB, L_EV_FLOOR, M_FLOOR,
                            PAIR_BUDGET, TABLE_KEYS, TILE_BUDGET,
                            MultiGraphArrays, _bucket, _pow2_at_least,
                            build_pair_tables, pair_count, pair_max_len,
                            pair_tiles, paired_fill, resolve_engine,
                            slice_pair_outputs)


def make_event_mesh(n_devices: Optional[int] = None,
                    axis_name: str = "events") -> Mesh:
    """Event-sharding mesh. Under jax.distributed (multi-host), events
    are partitioned across hosts FIRST (parallel/multihost.py) and each
    host shards its own events over its local chips only — event
    scoring needs no cross-host collectives, exactly like the
    reference's per-job population model (README.md:111-117) — so the
    mesh is local-device in multi-process runs."""
    devices = (jax.local_devices() if jax.process_count() > 1
               else jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


class ShardedPairedSW:
    """score_pairs()-compatible scorer that shards pairs over a mesh.

    Pairs are packed into per-device *slots* (each bounded by the column
    and pair budgets of PairedGraphSW chunks); S slots = one *round* =
    one sharded dispatch over the S-device mesh.
    """

    def __init__(self, graphs: Sequence[SequenceGraph],
                 mesh: Optional[Mesh] = None,
                 tile_batch: int = DEFAULT_TB, engine: str = None,
                 col_budget: int = COL_BUDGET):
        self.mesh = mesh if mesh is not None else make_event_mesh()
        (self.axis,) = self.mesh.axis_names
        S = self.mesh.devices.size
        self.n_shards = S
        self.tile_batch = tile_batch
        platform = self.mesh.devices.flat[0].platform
        self.engine = resolve_engine(platform, engine)
        self.bucketed = platform != "cpu"

        built = {}

        def build(g):
            key = id(g)
            if key not in built:
                built[key] = (GraphArrays.build(g),
                              GraphArrays.build(g.reversed()))
            return built[key]

        pair_gas = [build(g) for g in graphs]
        # same static-shape bucketing as PairedGraphSW: one compiled
        # program per run, shared across runs via the persistent cache
        n_max = _bucket(
            max(max(f.num_nodes, r.num_nodes) for f, r in pair_gas), 8)
        p_max = _pow2_at_least(
            max(max(f.pred_table.shape[1], r.pred_table.shape[1])
                for f, r in pair_gas), 2)

        # pack pairs into per-device slots: at least min(S, n_pairs) slots
        # so small event batches still spread over the whole mesh, and no
        # slot exceeds the column budget; longest-
        # processing-time greedy keeps the shards balanced
        pair_cols = [len(fa.ref_codes) + len(ra.ref_codes)
                     for fa, ra in pair_gas]
        total_cols = sum(pair_cols)
        n_slots = max(min(S, len(pair_gas)),
                      -(total_cols // -col_budget))
        slots: List[List[int]] = [[] for _ in range(n_slots)]
        loads = [0] * n_slots
        for i in sorted(range(len(pair_gas)), key=lambda i: -pair_cols[i]):
            k = min(range(len(slots)), key=lambda k: loads[k])
            if slots[k] and (loads[k] + pair_cols[i] > col_budget
                             or len(slots[k]) >= PAIR_BUDGET):
                slots.append([])
                loads.append(0)
                k = len(slots) - 1
            slots[k].append(i)
            loads[k] += pair_cols[i]
        self.slot_pairs = [s for s in slots if s]

        self.e_uni = 2 * PAIR_BUDGET
        self.l_uni = _bucket(max(col_budget, max(
            sum(pair_cols[i] for i in s) for s in self.slot_pairs)), 1024)
        self.slot_arrays: List[MultiGraphArrays] = []
        for idxs in self.slot_pairs:
            prebuilt = []
            for i in idxs:
                prebuilt.extend(pair_gas[i])
            self.slot_arrays.append(MultiGraphArrays(
                None, prebuilt=prebuilt, n_max=n_max, p_max=p_max,
                l_to=self.l_uni, e_to=self.e_uni))

        # uniform static shapes across every slot (and thus every round)
        self.L = max(len(a.ref_codes) for a in self.slot_arrays)
        self.E = max(a.pred_tables.shape[0] for a in self.slot_arrays)
        self.n_max = n_max
        self.p_max = p_max
        self.l_ev = max(L_EV_FLOOR, _bucket(
            max(max(a.col_len) for a in self.slot_arrays), 256))

        self.rounds: List[List[int]] = [
            list(range(r, min(r + S, len(self.slot_pairs))))
            for r in range(0, len(self.slot_pairs), S)
        ]

        # stack + pre-place the per-slot graph tables for each round
        self._round_dev = []
        sharding = NamedSharding(self.mesh, P(self.axis))

        def stack(slot_ids, attr, pad_val):
            outs = []
            for s in slot_ids:
                a = self.slot_arrays[s]
                x = getattr(a, attr)
                if x.ndim == 1:
                    x = np.pad(x, (0, self.L - len(x)),
                               constant_values=pad_val)
                else:  # pred_tables [E, N, P]
                    x = np.pad(x, ((0, self.E - x.shape[0]), (0, 0), (0, 0)),
                               constant_values=pad_val)
                outs.append(x)
            return np.stack(outs)

        for slot_ids in self.rounds:
            n_real = len(slot_ids)
            # pad the last round to S shards by re-scoring the first
            # slot's graphs against empty read sets (outputs discarded)
            full = list(slot_ids) + [slot_ids[0]] * (S - n_real)
            dev = jax.device_put(
                tuple(stack(full, attr, pv)
                      for attr, pv in (("packed_cols", 4),
                                       ("pred_tables", n_max))),
                sharding)
            self._round_dev.append((full, n_real, dev))

        self._fill = None

    def _make_fill(self, statics):
        mesh, axis = self.mesh, self.axis

        spec = P(axis)

        def shard_fn(*args):
            args = [x[0] for x in args]
            out = paired_fill(*args, **statics)
            return out[None]

        @jax.jit
        def fill(*args):
            # check_vma=False: the CUDA fill's FFI call carries no
            # varying-mesh-axes annotation, which the checker would reject
            return jax.shard_map(
                shard_fn, mesh=mesh, in_specs=(spec,) * len(args),
                out_specs=spec, check_vma=False)(*args)

        return fill

    def score_pairs_device(self, reads_per_pair: Sequence[List[str]],
                           pad_to: int = 0):
        S = self.n_shards
        tb = self.tile_batch
        sharding = NamedSharding(self.mesh, P(self.axis))
        max_len = max((pair_max_len(r) for r in reads_per_pair),
                      default=1)
        m_floor = M_FLOOR if self.bucketed else 32
        pad_to = max(pad_to, m_floor, _bucket(max_len, 32))

        pending = []
        for slot_ids, n_real, dev in self._round_dev:

            def slot_reads(k, s):
                if k >= n_real:  # shape-filler shard (zero tiles)
                    return [[] for _ in self.slot_pairs[s]]
                return [reads_per_pair[p] for p in self.slot_pairs[s]]

            # fixed tile/base budget (pow2 growth for oversize read sets):
            # pad tiles carry clen=0, so every shard — filler shards
            # included — pads to one shape at negligible cost
            tiles_raw = max(
                (sum(pair_tiles(pair_count(r), tb) for r in slot_reads(k, s))
                 for k, s in enumerate(slot_ids)), default=0)
            t_floor = TILE_BUDGET if self.bucketed else 1
            tiles_to = _pow2_at_least(tiles_raw, t_floor)
            reads_max = max(
                (sum(pair_count(r) for r in slot_reads(k, s))
                 for k, s in enumerate(slot_ids)), default=0)
            b_floor = 1024 if self.bucketed else 1
            bases_to = min(_pow2_at_least(reads_max, b_floor),
                           tiles_to * tb // 4)

            tables = [build_pair_tables(
                self.slot_arrays[s], slot_reads(k, s), tb,
                pad_to, tiles_to=tiles_to, bases_to=bases_to,
                l_ev_floor=self.l_ev)
                for k, s in enumerate(slot_ids)]
            statics = dict(L_ev=self.l_ev, N=self.n_max, P=self.p_max,
                           M=tables[0]["m"], TB=tb, engine=self.engine)
            if self._fill is None or self._fill[0] != tuple(
                    sorted(statics.items())):
                self._fill = (tuple(sorted(statics.items())),
                              self._make_fill(statics))
            fill = self._fill[1]

            # one batched sharded transfer for all per-round tables
            puts = jax.device_put(
                tuple(np.stack([t[k] for t in tables]) for k in TABLE_KEYS),
                sharding)
            out = fill(*dev, *puts)
            pending.append((slot_ids, n_real, tables, out))
        return pending, len(reads_per_pair)

    def score_pairs(self, reads_per_pair: Sequence[List[str]],
                    pad_to: int = 0):
        return self.finalize_pairs(
            self.score_pairs_device(reads_per_pair, pad_to))

    def finalize_pairs(self, handle):
        pending, n_pairs = handle
        results = [None] * n_pairs
        for slot_ids, n_real, tables, out in pending:
            vals = np.asarray(out)  # [S, 4, B]
            for k in range(n_real):
                s = slot_ids[k]
                slice_pair_outputs(
                    self.slot_arrays[s], vals[k], tables[k]["layout"],
                    self.slot_pairs[s], results)
        return results
