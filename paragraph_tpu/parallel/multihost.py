"""Multi-host distribution: event sharding across hosts.

The reference scales to populations by farming independent jobs and
merging VCFs (`bcftools merge`, /root/reference/README.md:111-117); the
equivalent here keeps that embarrassingly-parallel structure but
makes it one program: ``jax.distributed`` initializes the process group,
every host genotypes a strided shard of the event list on its local
chips (extraction and host analysis stay per-host — each host reads the
BAMs it needs), and the per-event genotyping JSONs are exchanged with a
``process_allgather`` between hosts so every host — and in particular host 0,
which writes the output VCF — holds the complete, event-ordered result.

No cross-host collective is needed *during* scoring or genotyping
(events are independent); the network between hosts carries only the
final small JSON shards, while read batches stay on each host's local
device mesh (parallel/distributed.py).
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

from ..utils.jaxcfg import configure as _jax_configure
_jax_configure()

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper (no-op if already connected).

    Pass the three arguments explicitly (coordinator address, process
    count, process id): nothing in a plain GPU host or CPU test
    environment lets JAX detect them."""
    # NB: must not touch jax.devices()/process_count() here — any backend
    # query before initialize() is an error by design
    if jax._src.distributed.global_state.client is not None:
        return
    # raise the Gloo/coordination rendezvous window beyond the 30s
    # default: co-located test processes under heavy machine load (and
    # real pods with slow container starts) can take longer to dial in
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               initialization_timeout=300)


def shard_events(n_events: int, process_id: Optional[int] = None,
                 num_processes: Optional[int] = None) -> List[int]:
    """Strided event assignment: host h takes events h::P. Striding (not
    contiguous blocks) balances heterogeneous event sizes the same way
    the reference's work queue drains mixed jobs."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return list(range(pid, n_events, n))


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """Exchange one bytes blob per process (padded uint8 allgather)."""
    from jax.experimental import multihost_utils

    data = np.frombuffer(payload, np.uint8)
    sizes = multihost_utils.process_allgather(
        np.asarray([data.size], np.int64))
    sizes = np.asarray(sizes).reshape(-1)
    m = max(1, int(sizes.max()))
    buf = np.zeros(m, np.uint8)
    buf[:data.size] = data
    gathered = np.asarray(multihost_utils.process_allgather(buf))
    return [bytes(gathered[p, :int(sizes[p])].tobytes())
            for p in range(gathered.shape[0])]


def run_grmpy_multihost(graph_descs: List[dict], reference_path: str,
                        manifest, genotyping_parameters=None,
                        parameters=None) -> List[dict]:
    """Event-ordered genotyping results across all hosts of the process
    group. Each host runs the full single-host pipeline (pipeline/grmpy
    .py — batched scoring on its local mesh, worker-pool host analysis)
    on its event shard; shards merge with one DCN allgather."""
    from ..pipeline.grmpy import run_grmpy

    n = len(graph_descs)
    mine = shard_events(n)
    local = run_grmpy([graph_descs[i] for i in mine], reference_path,
                      manifest, genotyping_parameters, parameters)

    if jax.process_count() == 1:
        return local

    payload = json.dumps({"events": mine, "results": local},
                         sort_keys=True).encode()
    merged: List[Optional[dict]] = [None] * n
    for blob in _allgather_bytes(payload):
        shard = json.loads(blob.decode())
        for gi, res in zip(shard["events"], shard["results"]):
            merged[gi] = res
    missing = [i for i, r in enumerate(merged) if r is None]
    if missing:
        raise RuntimeError(f"multihost merge missing events: {missing}")
    return merged
