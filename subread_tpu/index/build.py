"""Sorted 16-mer hash index as flat arrays, built host-side with numpy.

Reference equivalents: `gehash_t` + builder (sorted-hashtable.c:77-281,
index-builder.c:78-445).  The reference stores per-bucket sorted short
keys + positions in 64K slab groups with bucket = key % B and an
in-bucket binary search (sorted-hashtable.c:960-981).  This layout is
co-designed with the device gather instead, and minimises gathered
elements per probe:

    bucket_start : int32 [B+1]      B = 2**bucket_bits, bucket = key >> (32-bits)
    check_words  : uint32 [N/2+pad] half i%2 of word i//2 = check16(entry i)
    positions    : uint32 [N]       sorted by (canonical key, position)

Keys are stored CANONICAL — min(kmer, revcomp(kmer)) — with the
orientation (was-the-genome-kmer-flipped) in bit 0 of the check16 and
entries sorted by (key, orientation, position): each (key, orientation)
pair forms its own contiguous run, so a probe's full-check equality match
returns only entries of its required orientation — gather windows carry
no wrong-strand entries, and the rescue width is bounded by the
PER-ORIENTATION run length (<= REPEAT_THRESHOLD).

Because the bucket is the *high* bits of the canonical key, entries end
up globally sorted.  bucket_bits >= MIN_BUCKET_BITS keeps the key
remainder <= 15 bits, so check16 carries the WHOLE remainder: a check
match verifies full key identity (no aliasing), and checks are monotone
inside a bucket.  Small buckets are fetched as one fixed-width window
with no search.  Buckets longer than BIG_BUCKET (repeat families share
key prefixes, so prefix buckets skew heavily — chr901 has buckets of
1300+ entries) additionally get a SUB-BUCKET DIRECTORY: a per-big-bucket
table indexed by the next `sub_bits` bits of the key remainder that maps
a probe straight to its key run's start.  The builder raises sub_bits
until every run starts exactly at its sub-slot boundary, so the device
in-bucket binary search of the reference (sorted-hashtable.c:960-981)
costs TWO extra scalar gathers instead of a log2(max_bucket)-step loop
of them (a measured ~11ms per 16K x 10-probe dispatch on chr901).

Uninformative 16-mers occurring more than `repeat_threshold` (=100) times
are excluded, mirroring scan_gene_index/add_repeated_subread
(index-builder.c:472,447).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna
from .genome import Genome, genome_from_fasta

REPEAT_THRESHOLD = 100  # reference index-builder default (-f 100)
MAX_BUCKET_BITS = 28    # 1GB bucket_start ceiling (human full index)
MIN_BUCKET_BITS = 17    # key remainder <= 15 bits -> check16 verifies the
#                         FULL key (no aliasing) and stays monotone within a
#                         bucket, which the sub-bucket directory relies on
BIG_BUCKET = 16         # buckets longer than this get a sub-bucket directory
#                         (so the plain window path needs max_hits >= 16)
MAX_SUB_SLOTS = 1 << 27  # directory size cap (512MB of int32 slots)


@dataclass
class HashIndex:
    bucket_bits: int          # B = 1 << bucket_bits; bucket = key >> (32 - bits)
    bucket_start: np.ndarray  # int32 [B+1]
    keys: np.ndarray          # uint32 [N] CANONICAL 16-mer keys, sorted
    orient: np.ndarray        # bool [N] genome kmer was revcomp of canonical
    check_words: np.ndarray   # uint32 [N//4 + pad] packed check bytes
    positions: np.ndarray     # uint32 [N]
    index_gap: int
    padding: int
    max_bucket: int           # longest bucket: sets the device binary-search
    #                           trip count (ops.vote.gather_hits)
    max_run: int = 0          # longest single-key run: sets the rescue-pass
    #                           gather width (occurrences of one canonical key,
    #                           <= 2*REPEAT_THRESHOLD)

    @property
    def buckets_number(self) -> int:
        return 1 << self.bucket_bits

    @property
    def n_items(self) -> int:
        return len(self.keys)

    @property
    def sub_dir(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """Sub-bucket directory (sub_base, sub_lo, sub_bits, search_steps)
        for repeat-dense buckets — see module docstring.  Built lazily and
        cached (one vectorised pass over the sorted keys)."""
        if getattr(self, "_sub_dir", None) is None:
            self._sub_dir = build_sub_directory(
                self.keys, self.orient, self.bucket_start, self.bucket_bits
            )
        return self._sub_dir

    @property
    def comb_rows(self) -> np.ndarray:
        """Combined device rows: uint32 [G, 20] — 16 positions + their 16
        check bytes packed into 4 words per row of GROUP=16 entries, so
        ops.vote.gather_hits fetches whole probe windows as 2-D rows.
        Built lazily and cached (cheap reshuffle of positions+check_words)."""
        if getattr(self, "_comb_rows", None) is None:
            self._comb_rows = build_comb_rows(self.positions, self.check_words)
        return self._comb_rows

    def save(self, prefix: str) -> None:
        sb, sl, sbits, steps = self.sub_dir
        np.savez_compressed(
            prefix + ".hash.npz",
            version=np.int64(4),
            bucket_bits=np.int64(self.bucket_bits),
            bucket_start=self.bucket_start,
            keys=self.keys,
            orient=np.packbits(self.orient),
            positions=self.positions,
            index_gap=np.int64(self.index_gap),
            padding=np.int64(self.padding),
            max_bucket=np.int64(self.max_bucket),
            max_run=np.int64(self.max_run),
            sub_base=sb,
            sub_lo=sl,
            sub_bits=np.int64(sbits),
            sub_steps=np.int64(steps),
        )

    @classmethod
    def load(cls, prefix: str) -> "HashIndex":
        z = np.load(prefix + ".hash.npz")
        if "version" not in z:  # v1 mod-B layout: rebuild native from full keys
            B = np.uint64(int(z["buckets_number"]))
            short = z["keys"].astype(np.uint64)
            bucket_start = z["bucket_start"]
            counts = np.diff(bucket_start.astype(np.int64))
            bucket = np.repeat(
                np.arange(len(counts), dtype=np.uint64), counts
            )
            full = (short * B + bucket).astype(np.uint32)
            return native_layout(
                full, z["positions"], int(z["index_gap"]), int(z["padding"])
            )
        if int(z["version"]) == 2:
            # v2 stored non-canonical keys: rebuild the canonical layout
            return native_layout(
                z["keys"], z["positions"], int(z["index_gap"]),
                int(z["padding"])
            )
        orient = np.unpackbits(z["orient"])[: len(z["keys"])].astype(bool)
        if int(z["bucket_bits"]) < MIN_BUCKET_BITS or int(z["version"]) < 4:
            # pre-check16 or pre-orientation-split file: re-sort into the
            # (key, orient, pos) layout (the stored canonical keys/orient/
            # positions carry everything needed)
            rawkeys = np.where(
                orient, revcomp_keys_np(z["keys"].astype(np.uint32)),
                z["keys"].astype(np.uint32),
            )
            return native_layout(
                rawkeys, z["positions"], int(z["index_gap"]),
                int(z["padding"])
            )
        idx = cls(
            bucket_bits=int(z["bucket_bits"]),
            bucket_start=z["bucket_start"],
            keys=z["keys"],
            orient=orient,
            check_words=np.zeros(0, np.uint32),
            positions=z["positions"],
            index_gap=int(z["index_gap"]),
            padding=int(z["padding"]),
            max_bucket=int(z["max_bucket"]),
            max_run=int(z["max_run"]) if "max_run" in z else 0,
        )
        idx.check_words = pack_check_bytes(idx.keys, orient, idx.bucket_bits)
        if "sub_base" in z:
            idx._sub_dir = (
                z["sub_base"], z["sub_lo"], int(z["sub_bits"]),
                int(z["sub_steps"]),
            )
        return idx


def revcomp_keys_np(x: np.ndarray) -> np.ndarray:
    """Host mirror of ops.vote.revcomp_keys (bitwise NOT complements every
    2-bit base; swap ladder reverses the 16 groups)."""
    x = (~x.astype(np.uint32)).astype(np.uint32)
    m2, m4, m8 = np.uint32(0x33333333), np.uint32(0x0F0F0F0F), np.uint32(0x00FF00FF)
    x = ((x & m2) << np.uint32(2)) | ((x >> np.uint32(2)) & m2)
    x = ((x & m4) << np.uint32(4)) | ((x >> np.uint32(4)) & m4)
    x = ((x & m8) << np.uint32(8)) | ((x >> np.uint32(8)) & m8)
    return ((x << np.uint32(16)) | (x >> np.uint32(16))).astype(np.uint32)


def build_sub_directory(
    ks: np.ndarray, orient: np.ndarray, bucket_start: np.ndarray,
    bucket_bits: int, force_bits: int | None = None,
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Two-level lookup for buckets longer than BIG_BUCKET.

    For the k-th big bucket, `sub_lo[(sub_base[bucket] ... +2**sub_bits)]`
    holds, per value s of the top `sub_bits` bits of the in-bucket check
    ((remainder << 1) | orientation — see check16), the index of the first
    entry whose check-top >= s (empty slots point at the next occupied
    one; trailing empties at the bucket end).  sub_bits is raised until
    EVERY (key, orientation) run starts exactly at its slot's first entry
    (d_max == 0), so the device jump lands on the run start with no
    residual search; at sub_bits = 33 - bucket_bits the slot IS the full
    check, which guarantees d_max == 0, so search_steps > 0 can only
    happen under the MAX_SUB_SLOTS memory cap.

    Returns (sub_base int32 [B] (-1 = small bucket), sub_lo int32,
    sub_bits, search_steps).
    """
    B = 1 << bucket_bits
    counts = np.diff(bucket_start.astype(np.int64))
    bigmask = counts > BIG_BUCKET
    nbig = int(bigmask.sum())
    sub_base = np.full(B, -1, np.int32)
    if nbig == 0 or len(ks) == 0:
        return sub_base, np.zeros(1, np.int32), 0, 0
    rem_bits = 33 - bucket_bits      # check width incl. the orientation LSB
    bucket = (ks >> np.uint32(32 - bucket_bits)).astype(np.int64)
    in_big = bigmask[bucket]
    eidx = np.flatnonzero(in_big).astype(np.int64)  # global entry index
    kb = bucket[eidx]
    krank = np.cumsum(bigmask) - 1                  # bucket -> big rank
    kr = krank[kb].astype(np.int64)
    chk = (
        ((ks[eidx] & np.uint32((1 << (32 - bucket_bits)) - 1)) << np.uint32(1))
        | orient[eidx].astype(np.uint32)
    ).astype(np.uint32)
    kk = ks[eidx]
    oo = orient[eidx]
    is_start = np.concatenate(
        ([True],
         (kk[1:] != kk[:-1]) | (oo[1:] != oo[:-1]) | (kb[1:] != kb[:-1]))
    )
    ar = np.arange(len(eidx), dtype=np.int64)
    e = d_max = 0
    slot = slot_change = None
    candidates = (
        [min(force_bits, rem_bits)] if force_bits else range(1, rem_bits + 1)
    )
    for e in candidates:
        if (nbig << e) > MAX_SUB_SLOTS and slot is not None:
            e -= 1
            break
        sub = (chk >> np.uint32(rem_bits - e)).astype(np.int64)
        new_slot = (kr << e) | sub
        new_change = np.concatenate(([True], new_slot[1:] != new_slot[:-1]))
        slot, slot_change = new_slot, new_change
        last_change = np.maximum.accumulate(np.where(slot_change, ar, -1))
        d_max = int((ar - last_change)[is_start].max(initial=0))
        if d_max == 0:
            break
    E = 1 << e
    sub_base[bigmask] = (np.arange(nbig, dtype=np.int64) << e).astype(np.int32)
    ends = bucket_start[1:].astype(np.int64)
    sub_lo = np.repeat(ends[bigmask], E)            # default: bucket end
    sub_lo[slot[slot_change]] = eidx[slot_change]   # first entry per slot
    # empty slots point at the next occupied one: slot values rise within a
    # bucket, so a right-to-left running minimum fills them
    sub_lo = np.minimum.accumulate(
        sub_lo.reshape(nbig, E)[:, ::-1], axis=1
    )[:, ::-1].reshape(-1)
    steps = 0 if d_max == 0 else int(np.ceil(np.log2(d_max + 2)))
    return sub_base, sub_lo.astype(np.int32), e, steps


def _max_key_run(ks: np.ndarray, orient: np.ndarray) -> int:
    """Longest run of one (canonical key, orientation) pair in the sorted
    arrays — the rescue gather width bound (<= REPEAT_THRESHOLD per
    forward key thanks to the uninformative filter)."""
    if len(ks) == 0:
        return 0
    change = np.flatnonzero((ks[1:] != ks[:-1]) | (orient[1:] != orient[:-1]))
    bounds = np.concatenate([[-1], change, [len(ks) - 1]])
    return int(np.diff(bounds).max())


def check16(keys_u32: np.ndarray, orient: np.ndarray, bucket_bits: int):
    """Check half-word: bits 1-15 = the FULL in-bucket key remainder
    (bucket_bits >= MIN_BUCKET_BITS makes it <= 15 bits), bit 0 = the
    stored orientation (genome kmer was the revcomp of the canonical key).
    With the orientation in the LSB and entries sorted by (key, orient,
    pos), each (key, orientation) pair forms its own contiguous run with
    its own directory slot — a probe's 16-bit check equality match returns
    ONLY entries of its required orientation, so gather windows carry no
    wrong-strand entries and the per-run length bound halves (the
    uninformative filter caps each forward key at REPEAT_THRESHOLD
    occurrences per orientation)."""
    rem = (keys_u32 & np.uint32((1 << (32 - bucket_bits)) - 1)).astype(np.uint32)
    return (
        (rem << np.uint32(1)) | orient.astype(np.uint32)
    ).astype(np.uint16)


def pack_check_bytes(
    keys_u32: np.ndarray, orient: np.ndarray, bucket_bits: int
) -> np.ndarray:
    """check16 of every entry packed 2-per-uint32 (entry i in word i//2,
    half i%2), padded so a fixed-width word window never reads past the
    end."""
    n = len(keys_u32)
    npad = ((n + 1) // 2 + 24) * 2
    b = np.zeros(npad, np.uint16)
    b[:n] = check16(keys_u32, orient, bucket_bits)
    return b.view(np.uint32)


def build_comb_rows(positions: np.ndarray, check_words: np.ndarray) -> np.ndarray:
    """Pack positions + check16s into combined [G, 24] uint32 rows of
    GROUP=16 entries (see ops.vote.gather_hits).  Padded with 3 extra rows
    so a window starting at any entry never reads past the end."""
    n = len(positions)
    G = (n + 15) // 16 + 3
    pos_p = np.zeros(G * 16, np.uint32)
    pos_p[:n] = positions
    chk_p = np.zeros(G * 16, np.uint16)
    chk_p[:n] = check_words.view(np.uint16)[:n]
    comb = np.empty((G, 24), np.uint32)
    comb[:, :16] = pos_p.reshape(G, 16)
    comb[:, 16:] = chk_p.view(np.uint32).reshape(G, 8)
    return comb


def native_layout(
    keys: np.ndarray, positions: np.ndarray, index_gap: int, padding: int,
    bucket_bits: int | None = None,
) -> HashIndex:
    """Canonicalise and sort (key, position) pairs into the device layout.

    bucket_bits can be forced so several position-range shards share one
    bucket space (one jitted vote graph serves every shard)."""
    keys = keys.astype(np.uint32)
    rc = revcomp_keys_np(keys)
    canon = np.minimum(keys, rc)
    orient = canon != keys
    # single radix argsort on a fused (key, orient, position) 64-bit value
    # — a multi-key np.lexsort measured ~5x slower at 100M entries.  The
    # orientation sits between key and position so each (key, orientation)
    # pair is its own contiguous run (see check16).
    assert positions.max(initial=0) < (1 << 31)
    fused = (
        (canon.astype(np.uint64) << np.uint64(32))
        | (orient.astype(np.uint64) << np.uint64(31))
        | positions.astype(np.uint64)
    )
    order = np.argsort(fused, kind="stable")
    return _layout_from_sorted(
        canon[order], positions[order].astype(np.uint32), orient[order],
        index_gap, padding, bucket_bits,
    )


def _layout_from_sorted(
    ks: np.ndarray, ps: np.ndarray, orient: np.ndarray,
    index_gap: int, padding: int, bucket_bits: int | None = None,
) -> HashIndex:
    """Device layout from (canonical key, position)-sorted arrays."""
    n = max(len(ks), 2)
    if bucket_bits is None:
        bucket_bits = min(
            MAX_BUCKET_BITS,
            max(MIN_BUCKET_BITS, int(np.ceil(np.log2(n))) + 2),
        )
    shift = np.uint32(32 - bucket_bits)
    bucket = (ks >> shift).astype(np.int64)
    counts = np.bincount(bucket, minlength=1 << bucket_bits)
    bucket_start = np.zeros((1 << bucket_bits) + 1, dtype=np.int64)
    np.cumsum(counts, out=bucket_start[1:])
    assert bucket_start[-1] < 2**31
    return HashIndex(
        bucket_bits=bucket_bits,
        bucket_start=bucket_start.astype(np.int32),
        keys=ks,
        orient=orient,
        check_words=pack_check_bytes(ks, orient, bucket_bits),
        positions=ps,
        index_gap=index_gap,
        padding=padding,
        max_bucket=int(counts.max(initial=0)),
        max_run=_max_key_run(ks, orient),
    )


def _stepped_kmers(genome: Genome, gap: int) -> tuple[np.ndarray, np.ndarray]:
    """All (key, position) pairs at per-contig stepped offsets.

    No N-window skipping: the reference's FASTA sanity pass converts every
    non-ACGT genome character (including N) to 'A' before the scan
    (check_and_convert_FastA, index-builder.c:789+), so the scanned genome
    never contains N.  Long N runs become poly-A runs whose 16-mers are
    removed by the uninformative-mer filter instead."""
    all_keys = []
    all_pos = []
    for c in range(len(genome.names)):
        s = int(genome.starts[c])
        length = int(genome.lengths[c])
        if length < dna.KMER:
            continue
        codes = genome.codes[s : s + length]
        keys = dna.kmer_keys(codes)  # [length-15]
        if gap == 1:
            all_keys.append(keys)
            all_pos.append(
                (np.arange(len(keys), dtype=np.uint32) + np.uint32(s))
            )
        else:
            sel = np.arange(0, length - dna.KMER + 1, gap)
            all_keys.append(keys[sel])
            all_pos.append((sel + s).astype(np.uint32))
    if not all_keys:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    return np.concatenate(all_keys), np.concatenate(all_pos)


def build_hash_index(
    genome: Genome,
    index_gap: int = 1,
    repeat_threshold: int = REPEAT_THRESHOLD,
) -> HashIndex:
    """One canonical radix sort does double duty: layout ordering AND the
    uninformative-mer filter.  Forward-key occurrence counts (the
    reference counts genome-strand 16-mers, scan_gene_index
    index-builder.c:472) are recovered from each canonical run's orient
    split: within a run of canonical key c, entries with orient=0 carry
    forward key c and orient=1 carry rc(c), so per-run per-orient counts
    ARE the two forward-key counts."""
    keys, pos = _stepped_kmers(genome, index_gap)
    rc = revcomp_keys_np(keys)
    canon = np.minimum(keys, rc)
    orient = canon != keys
    del rc, keys
    assert pos.max(initial=0) < (1 << 31)
    fused = (
        (canon.astype(np.uint64) << np.uint64(32))
        | (orient.astype(np.uint64) << np.uint64(31))
        | pos.astype(np.uint64)
    )
    order = np.argsort(fused, kind="stable")
    del fused
    ks = canon[order]
    ps = pos[order]
    ori = orient[order]
    del canon, pos, orient, order

    starts = np.flatnonzero(np.concatenate(([True], ks[1:] != ks[:-1])))
    ends = np.concatenate((starts[1:], [len(ks)]))
    csum = np.concatenate(([0], np.cumsum(ori, dtype=np.int64)))
    n_rc = csum[ends] - csum[starts]          # orient=1 per run
    n_fwd = (ends - starts) - n_rc
    run_len = ends - starts
    # an entry survives when ITS forward key is informative
    keep_fwd = np.repeat(n_fwd <= repeat_threshold, run_len)
    keep_rc = np.repeat(n_rc <= repeat_threshold, run_len)
    keep = np.where(ori, keep_rc, keep_fwd)
    ks, ps, ori = ks[keep], ps[keep], ori[keep]
    return _layout_from_sorted(ks, ps, ori, index_gap, genome.padding)


def split_index_blocks(
    idx: HashIndex, memory_mb: int, overlap: int | None = None
) -> list[HashIndex]:
    """Split an index into position-range blocks bounded by memory.

    Reference: memory-bounded index splitting (build_gene_index,
    index-builder.c:78-445): each block covers a contiguous genome range
    with a MIN_READ_SPLICING overlap so reads straddling the cut vote in
    both blocks.  Vote tables are merged per read afterwards
    (ops.vote.merge_vote_results).
    """
    # ~6 bytes/entry device footprint (positions 4 + check 1 + bucket amort)
    max_entries = max(int(memory_mb * (1 << 20) / 6), 1 << 16)
    n = idx.n_items
    if n <= max_entries:
        return [idx]
    n_blocks = -(-n // max_entries)
    overlap = idx.padding if overlap is None else overlap
    order = np.argsort(idx.positions, kind="stable")
    pos_sorted = idx.positions[order]
    # idx.keys are canonical; native_layout re-canonicalises, so feed it
    # the original genome-strand kmers (revcomp where orient is set) or
    # every block would come out all-forward.
    genome_keys = np.where(idx.orient, revcomp_keys_np(idx.keys), idx.keys)
    blocks = []
    per = -(-n // n_blocks)
    for b in range(n_blocks):
        lo = b * per
        hi = min((b + 1) * per, n)
        if lo >= n:
            break
        cut_lo = int(pos_sorted[lo])
        cut_hi = int(pos_sorted[hi - 1])
        sel = (idx.positions >= max(cut_lo - (overlap if b else 0), 0)) & (
            idx.positions <= cut_hi + (overlap if hi < n else 0)
        )
        blocks.append(
            native_layout(
                genome_keys[sel], idx.positions[sel], idx.index_gap,
                idx.padding,
            )
        )
    return blocks


def load_index_blocks(prefix: str) -> list[HashIndex]:
    """Load `prefix.hash.npz` or the multi-block `prefix.NN.hash.npz` set."""
    import os

    if os.path.exists(prefix + ".hash.npz"):
        return [HashIndex.load(prefix)]
    blocks = []
    b = 0
    while os.path.exists(f"{prefix}.{b:02d}.hash.npz"):
        blocks.append(HashIndex.load(f"{prefix}.{b:02d}"))
        b += 1
    if not blocks:
        raise FileNotFoundError(prefix + ".hash.npz")
    return blocks


def build_index(
    fasta_path: str,
    out_prefix: str | None = None,
    index_gap: int = 1,
    repeat_threshold: int = REPEAT_THRESHOLD,
    memory_mb: int | None = None,
) -> tuple[Genome, HashIndex | list[HashIndex]]:
    """Full index build: FASTA → Genome + HashIndex (and save if prefix given).

    Reference: subread-buildindex main flow (index-builder.c:1014);
    `index_gap=1` is a full index (-F), 3 the default gapped index;
    `memory_mb` bounds the per-block device footprint (-M), splitting the
    index into `NN`-suffixed blocks like the reference's {prefix}.NN.b.tab.
    """
    genome = genome_from_fasta(fasta_path)
    idx = build_hash_index(genome, index_gap=index_gap, repeat_threshold=repeat_threshold)
    blocks = split_index_blocks(idx, memory_mb) if memory_mb else [idx]
    if out_prefix:
        genome.save(out_prefix)
        if len(blocks) == 1:
            idx.save(out_prefix)
        else:
            for b, blk in enumerate(blocks):
                blk.save(f"{out_prefix}.{b:02d}")
    return genome, (blocks if len(blocks) > 1 else idx)
