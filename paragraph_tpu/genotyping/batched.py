"""Vectorized genotyping likelihoods in JAX.

Device counterpart of the scalar parity engine in
``breakpoint_genotyper.py``: Poisson genotype likelihoods evaluated for
whole (events × samples × breakpoints) batches at once, suitable for
mesh-sharded population runs (SURVEY.md §2.3). The scalar float64 engine
remains the bit-parity path; this one trades double-precision boost
semantics for throughput.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import numpy as np

from ..utils.jaxcfg import configure as _jax_configure
_jax_configure()

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from .parameters import make_possible_genotypes


def genotype_tables(ploidy: int, num_alleles: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Return (gt_matrix[G, A] allele copy counts, gts list)."""
    gts = make_possible_genotypes(ploidy, num_alleles)
    mat = np.zeros((len(gts), num_alleles), dtype=np.int32)
    for i, gv in enumerate(gts):
        for g in gv:
            mat[i, g] += 1
    return mat, gts


def _log_poisson_pmf(k, mean):
    mean = jnp.maximum(mean, 1e-30)
    return k * jnp.log(mean) - mean - gammaln(k + 1.0)


@partial(jax.jit, static_argnames=("min_overlap",))
def batched_genotype_likelihoods(counts, depth, read_length, gt_ploidy,
                                 error_rates, het_fractions, log_priors,
                                 min_overlap: int = 16):
    """Genotype likelihoods for a batch.

    counts:        [..., A] int32 per-allele read counts
    depth:         [...] expected depth per item
    read_length:   [...] read length per item
    gt_ploidy:     [G, A] allele copy numbers per candidate genotype
    error_rates:   [A] per-allele error rates (ε)
    het_fractions: [A] per-allele haplotype fractions (μ)
    log_priors:    [G] log genotype priors

    Returns (gl[..., G], best_gt[...], gq[...]); mirrors
    BreakpointGenotyper::genotype (BreakpointGenotyper.cpp:86-151).
    """
    lam = depth * (read_length - min_overlap) / read_length  # [...]
    present = gt_ploidy > 0  # [G, A]
    rate = jnp.where(present, gt_ploidy * het_fractions, error_rates)
    mean = lam[..., None, None] * rate  # [..., G, A]
    lp = _log_poisson_pmf(counts[..., None, :].astype(jnp.float32), mean)
    gl = log_priors + jnp.sum(lp, axis=-1)  # [..., G]

    best = jnp.argmax(gl, axis=-1)
    best_gl = jnp.max(gl, axis=-1)
    # GQ = -10 log10(1 - exp(best)/sum(exp)) with the same caps as the
    # reference (log-sum-exp stabilised)
    lse = jax.scipy.special.logsumexp(gl, axis=-1)
    pr_err = -jnp.expm1(best_gl - lse)
    gq = jnp.where(
        pr_err <= 0, 100.0,
        jnp.minimum(-10.0 * jnp.log10(jnp.maximum(pr_err, 1e-300)), 100.0))
    return gl, best, gq


def make_model_inputs(allele_names: Sequence[str], ploidy: int = 2,
                      error_rate: float = 0.05, het_fraction: float = 0.5):
    """Convenience constructor for the default model parameters."""
    a = len(allele_names)
    gt_ploidy, gts = genotype_tables(ploidy, a)
    return {
        "gt_ploidy": jnp.asarray(gt_ploidy, jnp.float32),
        "error_rates": jnp.full((a,), error_rate, jnp.float32),
        "het_fractions": jnp.full((a,), het_fraction, jnp.float32),
        "log_priors": jnp.zeros((gt_ploidy.shape[0],), jnp.float32),
        "gts": gts,
    }


def model_from_parameters(param) -> dict:
    """Device-model tables from a GenotypingParameters object, with the
    same per-allele defaults the float64 engine applies
    (vectorized.py:55-74)."""
    import math

    a = param.num_alleles
    gts = param.possible_genotypes
    mat = np.zeros((len(gts), a), np.float32)
    for i, gv in enumerate(gts):
        for g in gv:
            mat[i, g] += 1
    eps = (list(param.allele_error_rates) if param.allele_error_rates
           else [param.other_allele_error_rate] * a)
    mu = (list(param.het_haplotype_fractions)
          if param.het_haplotype_fractions
          else [param.other_het_haplotype_fraction] * a)
    prior = {tuple(gt): math.log(frac)
             for gt, frac in param.genotype_fractions.items() if frac > 0}
    logp = [prior.get(tuple(gv), 0.0) for gv in gts]
    return {
        "gt_ploidy": jnp.asarray(mat),
        "error_rates": jnp.asarray(eps, jnp.float32),
        "het_fractions": jnp.asarray(mu, jnp.float32),
        "log_priors": jnp.asarray(logp, jnp.float32),
        "gts": gts,
    }


def _normal_sf_upper(x, mean, sd):
    """P(X <= x) for Normal(mean, sd) via erfc (BreakpointGenotyper.cpp
    uses boost's normal cdf; float32 device analogue)."""
    return 0.5 * jax.scipy.special.erfc(
        -(x - mean) / (sd * jnp.sqrt(2.0)))


@partial(jax.jit, static_argnames=("min_overlap", "min_pass_gq"))
def batched_genotype_full(counts, depth, read_length, depth_sd,
                          use_poisson, gt_ploidy, error_rates,
                          het_fractions, log_priors,
                          coverage_cutoff=(0.02, 0.0001),
                          min_overlap: int = 16, min_pass_gq: int = 10):
    """Complete device genotyping step for a batch: likelihoods + best
    GT + GQ (int-truncated like the C++ -10*log10 cast) + NO_READS/GQ/
    BP_DEPTH filter flags + allele fractions + depth-test p-value.

    Mirrors BreakpointGenotyper::genotype (BreakpointGenotyper.cpp:
    86-192) in float32 for pod-scale population runs; the bit-parity
    float64 engine is genotyping/vectorized.py. Shapes: counts [..., A];
    depth/read_length/depth_sd/use_poisson [...]; returns a dict of
    arrays with leading shape [...].
    """
    gl, best, _ = batched_genotype_likelihoods(
        counts, depth, read_length, gt_ploidy, error_rates,
        het_fractions, log_priors, min_overlap=min_overlap)

    lam = depth * (read_length - min_overlap) / read_length
    total = jnp.sum(counts, axis=-1)
    no_reads = total == 0

    best_gl = jnp.max(gl, axis=-1)
    lse = jax.scipy.special.logsumexp(gl, axis=-1)
    pr_err = -jnp.expm1(best_gl - lse)
    gq_log10 = jnp.log10(jnp.maximum(pr_err, 1e-300))
    gq = jnp.where((pr_err <= 0) | (gq_log10 < -10), 100,
                   (-10.0 * gq_log10).astype(jnp.int32))
    gq_filter = (~no_reads) & (gq < min_pass_gq)

    fractions = counts / jnp.maximum(total, 1)[..., None]

    totf = total.astype(jnp.float32)
    normal_p = _normal_sf_upper(totf, lam, depth_sd)
    # P(X <= k) = Q(k+1, lam) (regularized upper incomplete gamma)
    poisson_p = jax.scipy.special.gammaincc(totf + 1.0, lam)
    pv = jnp.where(use_poisson, poisson_p, normal_p)
    upper = pv > 0.5
    pv_two = jnp.where(upper, 1.0 - pv, pv)
    bp_depth = (~no_reads) & jnp.where(
        upper, pv_two < coverage_cutoff[0], pv_two < coverage_cutoff[1])

    return {
        "gl": gl, "best_gt": best, "gq": gq, "num_reads": total,
        "allele_fractions": fractions, "coverage_test_pvalue": pv_two,
        "no_reads": no_reads, "gq_filter": gq_filter,
        "bp_depth": bp_depth,
    }


@jax.jit
def combined_consensus_batch(best_gt, pass_mask, has_gt):
    """Vectorized whole-variant consensus over the breakpoint axis
    (CombinedGenotype.cpp:46-109 fast path): per sample, if every PASS
    breakpoint votes the same genotype the consensus is that genotype;
    otherwise the sample needs the conflict path (re-genotype on summed
    counts), flagged here for the host to resolve.

    best_gt [S, BP] int32; pass_mask/has_gt [S, BP] bool.
    Returns (consensus_gt [S] — -1 where unresolved, conflict [S] bool).
    """
    votes = jnp.where(pass_mask & has_gt, best_gt, -1)
    first = jnp.max(votes, axis=-1)  # a pass vote if any (-1 otherwise)
    agree = jnp.all((votes == -1) | (votes == first[..., None]), axis=-1)
    any_pass = jnp.any(votes >= 0, axis=-1)
    consensus = jnp.where(any_pass & agree, first, -1)
    conflict = any_pass & ~agree
    return consensus, conflict
