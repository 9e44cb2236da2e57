"""deciphon_tpu — a JAX profile-HMM DNA annotation framework for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of EBI-Metagenomics/deciphon-old
(EBI-Metagenomics/deciphon-old), designed for an accelerator:

- profiles are compiled into dense per-state tensors (codon log-marginals,
  background nucleotide log-probs, transition vectors) instead of
  pointer-graph HMMs compiled to sparse DP (reference: imm_hmm -> imm_dp);
- the frameshift-tolerant codon Viterbi recurrence runs as a batched
  max-plus scan (JAX lax.scan reference path + Pallas-Triton GPU kernel),
  vectorized over profile nodes and gridded over (reads x profiles);
- the profile database is sharded over a jax.sharding.Mesh 'profiles'
  axis with collective hit merges, replacing the reference's OpenMP
  partitioned file readers (src/db/profile_reader.c).

Subpackages:
  utils    - return codes, logging, config, hashing cache, math helpers
  models   - alphabets/genetic code, frame-state emission model,
             profile builder, HMMER3 reader, tensorized profiles
  ops      - Viterbi engines (numpy oracle, JAX scan, GPU kernel)
  db       - tensorized profile database format + partitioning
  parallel - device mesh + sharded scan engine
  server   - scheduler REST client, job runtime, product writer
  cli      - command line entry points
"""

__version__ = "0.1.0"
