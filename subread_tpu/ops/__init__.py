"""Device kernels: vote-gather, banded DP, selection.

These are the dense-batch re-designs of the reference's hot loops
(SURVEY.md §3.2): `gehash_go_X` (sorted-hashtable.c:937) becomes a dense
batched gather + sorted-candidate sliding-window vote count; the banded
Smith-Waterman (`core_dynamic_align`, core-indel.c:4573) becomes a
fixed-band wavefront kernel.  All of it is plain jax.numpy/lax, compiled
by XLA.
"""
