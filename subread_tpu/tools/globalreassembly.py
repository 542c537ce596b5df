"""globalReassembly: de-novo greedy contig assembly from reads.

JAX-framework port of the reference's experimental standalone assembler
(global-reassembly.c; usage :153-157, driver main :1740).  The reference
indexes every read fragment in an lnhash vote table and grows a contig by
repeatedly voting for reads that overlap its current tip
(search_read_extension_number :631, extension scoring :1400-1520), writing
contigs as ``>SEQn_LENm`` FASTA records (:1110).

Here the same seed-and-extend loop is host-side numpy: a sorted
(16-mer-key, read, offset, strand) table replaces the lnhash; a candidate
read's votes are the number of its 16-mers agreeing on one placement
offset against the contig tip (the vote-record head_position clustering),
gated by ``--requiredVotes``/``--extensionVotes`` and a mismatch check
over the full overlap (maximum_mismatch_in20bp analog), then the best
extension (most new bases among top-voted) is appended.  Defaults follow
GRA_init: min overlap votes 2, min extension votes 2, min contig length
251 (global-reassembly.c:295-305).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import dna

KMER = 16


def _kmer_keys(codes: np.ndarray) -> np.ndarray:
    """Packed big-endian 2-bit 16-mer keys at every offset of a 1-D read;
    length max(len-15, 0)."""
    L = len(codes)
    if L < KMER:
        return np.zeros(0, np.uint64)
    acc = np.zeros(L - KMER + 1, np.uint64)
    for j in range(KMER):
        acc |= codes[j : L - KMER + 1 + j].astype(np.uint64) << np.uint64(
            2 * (KMER - 1 - j)
        )
    return acc


class _KmerTable:
    """Sorted (key, read, offset, strand) table over all reads: the lnhash
    analog (long-hashtable.c) with numpy searchsorted lookups."""

    def __init__(self, reads: list[np.ndarray]):
        keys, rid, off, strand = [], [], [], []
        for i, r in enumerate(reads):
            for s, seq in enumerate((r, dna.revcomp(r))):
                k = _kmer_keys(seq)
                keys.append(k)
                rid.append(np.full(len(k), i, np.int32))
                off.append(np.arange(len(k), dtype=np.int32))
                strand.append(np.full(len(k), s, np.int8))
        self.keys = np.concatenate(keys) if keys else np.zeros(0, np.uint64)
        order = np.argsort(self.keys, kind="stable")
        self.keys = self.keys[order]
        self.rid = np.concatenate(rid)[order] if keys else np.zeros(0, np.int32)
        self.off = np.concatenate(off)[order] if keys else np.zeros(0, np.int32)
        self.strand = (
            np.concatenate(strand)[order] if keys else np.zeros(0, np.int8)
        )

    def lookup(self, query_keys: np.ndarray):
        """For each query key (with its contig offset), all stored
        occurrences: (contig_koff, read, read_koff, strand) arrays."""
        lo = np.searchsorted(self.keys, query_keys, side="left")
        hi = np.searchsorted(self.keys, query_keys, side="right")
        n = hi - lo
        total = int(n.sum())
        qi = np.repeat(np.arange(len(query_keys)), n)
        pos = np.concatenate(
            [np.arange(a, b) for a, b in zip(lo, hi) if b > a]
        ) if total else np.zeros(0, np.int64)
        return qi, self.rid[pos], self.off[pos], self.strand[pos]


def _mismatches(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    return int((a[:n] != b[:n]).sum())


class Assembler:
    def __init__(self, reads, min_overlap_votes, min_extension_votes,
                 tip_window=400):
        self.reads = reads
        self.table = _KmerTable(reads)
        self.used = np.zeros(len(reads), bool)
        self.vmin = min_overlap_votes
        self.emin = min_extension_votes
        self.tip = tip_window

    def _extend_right(self, contig: np.ndarray) -> np.ndarray | None:
        """One rightward extension step: returns the grown contig or None.

        Candidate scoring mirrors global-reassembly.c:1447-1520: votes =
        16-mers at one consistent placement, full-overlap mismatch gate
        (≤1 for overlaps >20bp, 0 otherwise), best = most new bases."""
        tipseq = contig[-self.tip :]
        tip0 = len(contig) - len(tipseq)
        qk = _kmer_keys(tipseq)
        if len(qk) == 0:
            return None
        qi, rid, roff, rstrand = self.table.lookup(qk)
        live = ~self.used[rid]
        if not live.any():
            return None
        qi, rid, roff, rstrand = qi[live], rid[live], roff[live], rstrand[live]
        # placement of read r: contig coordinate of read base 0
        place = (tip0 + qi) - roff
        # vote per (read, strand, place): count via unique on packed triple
        packed = (
            rid.astype(np.int64) << 40
            | rstrand.astype(np.int64) << 32
            | (place.astype(np.int64) + (1 << 20))
        )
        uniq, counts = np.unique(packed, return_counts=True)
        ok = counts >= max(self.emin, 1)
        if not ok.any():
            return None
        uniq, counts = uniq[ok], counts[ok]
        u_rid = (uniq >> 40).astype(np.int64)
        u_strand = (uniq >> 32) & 1
        u_place = (uniq & ((1 << 32) - 1)) - (1 << 20)
        rlen = np.array([len(self.reads[i]) for i in u_rid])
        new_bases = u_place + rlen - len(contig)
        cand = new_bases > 0
        if not cand.any():
            return None
        order = np.lexsort((-(counts[cand]), -new_bases[cand]))
        for j in np.flatnonzero(cand)[order]:
            i, s, p = int(u_rid[j]), int(u_strand[j]), int(u_place[j])
            seq = self.reads[i] if s == 0 else dna.revcomp(self.reads[i])
            ov_start = max(p, 0)
            ov = contig[ov_start:]
            rseq_ov = seq[ov_start - p :]
            ov_len = min(len(ov), len(rseq_ov))
            if ov_len < KMER:
                continue
            max_mm = 1 if ov_len > 20 else 0
            if _mismatches(ov, rseq_ov) > max_mm:
                continue
            if counts[j] < self.vmin:
                continue
            self.used[i] = True
            return np.concatenate([contig, seq[ov_len + (ov_start - p) :]])
        return None

    def assemble_from(self, seed: int) -> np.ndarray:
        """Grow a contig from one seed read, both directions
        (GRA_add_new_extension_part appends head or tail,
        global-reassembly.c:171-203)."""
        self.used[seed] = True
        contig = self.reads[seed].copy()
        while True:
            grown = self._extend_right(contig)
            if grown is None:
                break
            contig = grown
        # leftward: reverse-complement, extend right, flip back
        contig = dna.revcomp(contig)
        while True:
            grown = self._extend_right(contig)
            if grown is None:
                break
            contig = grown
        contig = dna.revcomp(contig)
        self._absorb(contig)
        return contig

    def _absorb(self, contig: np.ndarray):
        """Mark unused reads wholly contained in the contig as used, so
        interior reads skipped by best-extension steps don't reseed
        duplicate contigs."""
        qk = _kmer_keys(contig)
        if len(qk) == 0:
            return
        qi, rid, roff, rstrand = self.table.lookup(qk)
        live = ~self.used[rid]
        qi, rid, roff, rstrand = qi[live], rid[live], roff[live], rstrand[live]
        if len(qi) == 0:
            return
        place = qi - roff
        packed = (
            rid.astype(np.int64) << 40
            | rstrand.astype(np.int64) << 32
            | (place.astype(np.int64) + (1 << 20))
        )
        uniq, counts = np.unique(packed, return_counts=True)
        ok = counts >= max(self.emin, 1)
        u_rid = (uniq[ok] >> 40).astype(np.int64)
        u_strand = (uniq[ok] >> 32) & 1
        u_place = (uniq[ok] & ((1 << 32) - 1)) - (1 << 20)
        for j in range(len(u_rid)):
            i, s, p = int(u_rid[j]), int(u_strand[j]), int(u_place[j])
            if self.used[i] or p < 0:
                continue
            r = self.reads[i]
            if p + len(r) > len(contig):
                continue
            seq = r if s == 0 else dna.revcomp(r)
            if _mismatches(contig[p : p + len(r)], seq) <= 1:
                self.used[i] = True


def _load_reads(args) -> list[np.ndarray]:
    reads: list[np.ndarray] = []

    def add_batch(batch, trim):
        off = 64 if args.phred64 else 33
        for i in range(len(batch)):
            L = int(batch.lengths[i])
            codes = batch.codes[i, :L]
            if trim > 0:
                q = batch.quals[i, :L].astype(np.int32) - off
                good = np.flatnonzero(q >= trim)
                if len(good) == 0:
                    continue
                codes = codes[: good[-1] + 1]
            if len(codes) >= KMER:
                reads.append(codes.copy())

    from ..io.fastq import read_fastq

    if args.BAMinput or _looks_sam(args.input):
        from .utilities import _sam_records

        for rec in _sam_records(args.input):
            flag = int(rec[1])
            if flag & 0x100 or flag & 0x800:
                continue
            seq = rec[9].encode()
            codes = dna.BASE2CODE[np.frombuffer(seq, np.uint8)]
            if flag & 0x10:
                codes = dna.revcomp(codes)
            elif flag & 0x4 and args.reverseUnmapped:
                codes = dna.revcomp(codes)
            if len(codes) >= KMER:
                reads.append(codes)
    else:
        add_batch(read_fastq(args.input), args.trimQuality)
        if args.input2:
            add_batch(read_fastq(args.input2), args.trimQuality)
    return reads


def _looks_sam(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(2)
        if head == b"\x1f\x8b":
            import gzip

            with gzip.open(path, "rb") as g:
                return g.read(4) == b"BAM\x01"
        line = (head + f.readline()).decode(errors="replace")
    return line.startswith("@HD") or line.startswith("@SQ") or "\t" in line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="globalReassembly",
        description="assemble reads into contigs (global-reassembly.c port)",
    )
    ap.add_argument("-i", "--in", dest="input", required=True)
    ap.add_argument("-I", dest="input2", default=None, help="second FASTQ (PE)")
    ap.add_argument("-o", "--out", dest="output", required=True)
    ap.add_argument("-b", "--BAMinput", action="store_true")
    ap.add_argument("-R", "--reverseUnmapped", action="store_true")
    ap.add_argument("-6", "--phred64", action="store_true")
    ap.add_argument("-L", "--reportLength", type=int, default=251,
                    help="minimum contig length reported (default 251)")
    ap.add_argument("-V", "--requiredVotes", type=int, default=2)
    ap.add_argument("-v", "--extensionVotes", type=int, default=2)
    ap.add_argument("-Q", "--trimQuality", type=int, default=0)
    ap.add_argument("-T", "--threads", type=int, default=1)
    ap.add_argument("-H", "--hugeMemory", action="store_true")
    args = ap.parse_args(argv)

    reads = _load_reads(args)
    asm = Assembler(reads, args.requiredVotes, args.extensionVotes)
    n_out = 0
    with open(args.output, "w") as out:
        for seed in range(len(reads)):
            if asm.used[seed]:
                continue
            contig = asm.assemble_from(seed)
            if len(contig) >= args.reportLength:
                out.write(
                    f">SEQ{n_out}_LEN{len(contig)}\n{dna.decode(contig)}\n"
                )
                n_out += 1
    print(
        f"// globalReassembly: {len(reads)} reads -> {n_out} contigs "
        f">= {args.reportLength}bp",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
