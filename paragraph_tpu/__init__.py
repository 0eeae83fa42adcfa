"""paragraph_tpu — a graph-genotyping engine on JAX.

A from-scratch reimplementation of the capabilities of Illumina/paragraph
(reference at /root/reference), built around a batched device fill:

- Host data plane (pure Python + C++): VCF → sequence-graph construction,
  BAM/CRAM targeted read extraction, FASTA access, manifests, VCF emission.
- Device compute plane (JAX/XLA, CUDA through jax.ffi): batched graph
  Smith-Waterman
  alignment over concatenated event graphs, vectorized read classification and
  counting, Poisson genotype likelihood models over (events × samples ×
  breakpoints), sharded across a `jax.sharding.Mesh` on several devices.

Layer map (mirrors SURVEY.md §1 of the reference analysis):
  L0  align.gssw     — graph affine-gap SW (scalar oracle; device fills in ops/)
  L1  graph.model    — graph data model (nodes/edges/labels/paths/coordinates)
  L2  io             — FASTA / BGZF / BAM+BAI / VCF / manifest IO
  L3  align          — aligner cascade (exact-path kmer, graph SW)
  L4  reads          — filters, disambiguation, fragment counting, statistics
  L5  genotyping     — breakpoint Poisson model, consensus, population stats
  L6  pipeline       — paragraph / grmpy / multigrmpy / vcfupdate / idxdepth
  L7  parallel       — device mesh, event sharding, collective merges
"""

__version__ = "0.1.0"
