"""Device-mesh primitives for sharded genotyping.

The reference is single-node (thread pools over graphs and samples,
SURVEY.md §2.3); here the distribution axes are:

- reads   → data-parallel inside the multi-event fill's batch dimension
  (ops/multi_sw.py); per-edge read counts merge with psum
  (``merged_edge_counts``).
- events  → sharded across devices: alignment scoring via
  ``parallel.distributed.ShardedPairedSW`` (the production scorer), and
  the genotyping model via ``sharded_population_genotyping`` below — one
  SPMD program over a ``jax.sharding.Mesh``, XLA inserting collectives.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.jaxcfg import configure as _jax_configure
_jax_configure()

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def sharded_population_genotyping(mesh: Mesh, counts, depth, read_length,
                                  depth_sd, use_poisson, model,
                                  axis_name: str = "data",
                                  min_pass_gq: int = 10):
    """Population-scale genotyping: one device step over a batch of
    (event × sample × breakpoint) items sharded across the mesh.

    counts [N, A] and the per-item scalars [N] shard over ``axis_name``
    (pad N to a multiple of the mesh size); the model tables replicate.
    Runs genotyping/batched.py's full float32 model — likelihoods, best
    GT, GQ, NO_READS/GQ/BP_DEPTH filters, allele fractions, depth test —
    with no cross-item communication (items are independent, exactly
    like the reference's per-breakpoint loop). Returns the dict of
    result arrays, fully addressable on the host.
    """
    from ..genotyping.batched import batched_genotype_full

    batch = NamedSharding(mesh, P(axis_name))
    mat = NamedSharding(mesh, P(axis_name, None))
    repl = NamedSharding(mesh, P())

    def place(x, sharding):
        return jax.device_put(jnp.asarray(x), sharding)

    out = batched_genotype_full(
        place(np.asarray(counts, np.int32), mat),
        place(np.asarray(depth, np.float32), batch),
        place(np.asarray(read_length, np.float32), batch),
        place(np.asarray(depth_sd, np.float32), batch),
        place(np.asarray(use_poisson, bool), batch),
        place(model["gt_ploidy"], repl),
        place(model["error_rates"], repl),
        place(model["het_fractions"], repl),
        place(model["log_priors"], repl),
        min_pass_gq=min_pass_gq)
    return {k: np.asarray(v) for k, v in out.items()}


def merged_edge_counts(mesh: Mesh, local_support, axis_name: str = "data"):
    """Merge per-shard edge-support counts with an explicit psum
    (the reference's population-scale merge is `bcftools merge` of
    independent jobs, README.md:111-117; on a pod slice it is a single
    collective over ICI).

    local_support: [B, E] 0/1 fragment-supports-edge indicators sharded
    over reads; returns the global per-edge counts [E] replicated.
    """
    @jax.jit
    def merge(sup):
        def local(sup_block):
            return jax.lax.psum(
                jnp.sum(sup_block, axis=0, dtype=jnp.int32), axis_name)

        return jax.shard_map(
            local, mesh=mesh,
            in_specs=P(axis_name, None), out_specs=P())(sup)

    return merge(jax.device_put(
        jnp.asarray(local_support),
        NamedSharding(mesh, P(axis_name, None))))
