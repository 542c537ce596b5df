"""subread_tpu — a JAX seed-and-vote sequence-analysis engine.

A from-scratch JAX/XLA framework with the capabilities of the Subread
package (reference: ShiLab-Bioinformatics/subread v2.0.6): genome index
building, seed-and-vote short-read alignment (subread-align), exon-exon
junction discovery (subjunc), SNP calling (exactSNP), read-to-feature
quantification (featureCounts) and single-cell counting (cellCounts).

Layer map (bottom → top), mirroring SURVEY.md §1 but device-first:

  dna.py            base codecs, 2-bit packing, k-mer keys        (ref L0)
  io/               FASTA/FASTQ/SAM/BAM/GTF/VCF codecs            (ref L1)
  index/            genome + sorted 16-mer hash as device arrays  (ref L2)
  ops/              JAX kernels: vote-gather, banded DP           (ref hot loops)
  align/            two-scan chunked alignment pipeline           (ref L3)
  quant/            featureCounts / exactSNP / cellCounts         (ref L5)
  parallel/         mesh + sharding: DP reads × sharded index     (new)
  tools/            CLI front-ends                                 (ref L4)
"""

__version__ = "0.1.0"
