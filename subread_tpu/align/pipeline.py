"""The two-scan alignment pipeline.

Reference: `read_chunk_circles` (core.c:3539-3685) orchestrating
STEP_VOTING (`do_voting`, core.c:3049) and STEP_ITERATION_TWO
(`do_iteration_two`, core.c:2486) over 20M-read chunks, with pthread
data-parallelism.  Device-first redesign:

  * a chunk is a dense [R, L] int8 batch resident in device memory;
  * scan 1 = `ops.vote.vote_batch` (one fused jit);
  * scan 2 = `_scan2` below (one fused jit): candidate scoring via the
    single-indel split scan, best-candidate selection with the reference's
    integer score (core.c:2731-2739), soft-clip bounds, MAPQ;
  * SAM text assembly happens host-side from small int arrays.

Data parallelism across chips shards the R axis (see parallel/), replacing
the reference's thread pool; the index is replicated when it fits device
memory and sharded otherwise (SURVEY.md §2 parallelism table).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.jaxenv import ensure_compile_cache

ensure_compile_cache()

from .. import dna
from ..config import AlignConfig
from ..index.build import HashIndex
from ..index.genome import Genome
from ..io import sam as samio
from ..io.fastq import FastqReader, ReadBatch
from ..ops.extend import (
    genome_base,
    mismatch_matrix,
    softclip_from_prefix,
    oriented_read,
    place_single_indel,
    ref_clip_stats,
    softclip_bounds,
)
from ..ops.vote import VoteParams, VoteResult, merge_vote_results, vote_batch


@dataclass
class AlignSummary:
    total: int = 0
    mapped: int = 0
    unique: int = 0
    multi: int = 0
    unmapped: int = 0
    indels: int = 0
    time_voting: float = 0.0
    time_realign: float = 0.0
    time_io: float = 0.0

    def as_dict(self):
        return self.__dict__.copy()


def write_indel_vcf(path: str, genome: Genome, indels: dict) -> None:
    """Write {output}.indel.vcf (reference core-indel.c:2233-2254).
    indels: (contig_idx, pos0_anchor, indel_len) -> (support, inserted_seq)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.0\n")
        f.write('##INFO=<ID=INDEL,Number=0,Type=Flag,Description="Indicates that the variant is an INDEL.">\n')
        f.write('##INFO=<ID=SR,Number=1,Type=Integer,Description="Number of supporting reads">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for (cidx, pos0, ilen), (sup, ins_seq) in sorted(indels.items()):
            lin = genome.chro_to_linear(cidx, pos0)
            if ilen > 0:  # deletion
                ref_s = dna.decode(genome.codes[lin : lin + ilen + 1])
                alt_s = ref_s[0]
            else:
                ref_s = dna.decode(genome.codes[lin : lin + 1])
                alt_s = ref_s + ins_seq
            f.write(
                f"{genome.names[cidx]}\t{pos0 + 1}\t.\t{ref_s}\t{alt_s}"
                f"\t.\t.\tINDEL;SR={sup}\n"
            )


def collect_junctions(res: dict, batch, genome, table: dict,
                      mask: np.ndarray | None = None) -> dict | None:
    """Accumulate junction events from a result batch into the shared
    event table; also returns {(left_lin, right_lin): donor_strand}.

    mask: only count these rows.  The reference's junction.bed holds
    exactly the junctions of its REPORTED records (its bed and SAM
    junction sets are identical on the subjunc PE test) — final-table
    calls pass the emit predicate so unreported (multi-mapping /
    out-of-range) reads and unconfirmed seeds never add support."""
    if "junc" not in res:
        return None
    donor_of = {}
    junc = np.asarray(res["junc"], bool)
    if mask is not None:
        junc = junc & np.asarray(mask, bool)
        # chained (cigar_override) rows: res["pos"] was moved to the chain
        # start while split/junc_gap kept their pre-chain values, so a key
        # built here would mix frames and mint a phantom junction.  Their
        # junctions (head/tail events + the primary, all in consistent
        # frames) are counted by chain_clipped_junctions itself.
        for i in (res.get("cigar_override") or {}):
            if i < len(junc):
                junc[i] = False
    sel = np.flatnonzero(junc)
    if len(sel) == 0:
        return donor_of
    lin = res["pos"].astype(np.int64)
    cidx, coff = genome.linear_to_chro(lin)
    for i in sel:
        split = int(res["split"][i])
        gap = int(res["junc_gap"][i])
        L = int(batch.lengths[i])
        p0 = int(coff[i])
        left_edge = p0 + split - 1
        right_edge = p0 + split + gap
        key = (
            genome.names[int(cidx[i])], left_edge, right_edge,
            int(res["junc_donor_strand"][i]),
        )
        jcl = int(res["clip_l"][i]) if "clip_l" in res else 0
        jcr = int(res["clip_r"][i]) if "clip_r" in res else 0
        sup, ml, mr = table.get(key, (0, 0, 0))
        table[key] = (sup + 1, max(ml, split), max(mr, L - jcl - split - jcr))
        donor_of[(int(lin[i]) + split - 1, int(lin[i]) + split + gap)] = int(
            res["junc_donor_strand"][i]
        )
    return donor_of


def _calc_tlen_cigar(cigar: str, Ps: int, Pb: int, Lbig: int,
                     Lsm: int) -> int:
    """Literal calc_tlen walk (core.c:1718) over a CIGAR string: S and M
    consume chro+read, I consumes read, D/N consume chro; at every
    I/D/N boundary and at the end, if section_end >= Pb the walk stops
    with read_cursor + Pb - section_end + Lbig."""
    chro = Ps
    read = 0
    section_end = 0
    num = 0
    ops = []
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append((num, ch))
            num = 0
    for j, (n, op) in enumerate(ops):
        if op in "MS=X":
            chro += n
            read += n
            section_end = chro
        last = j == len(ops) - 1
        if op in "NDI" or last:
            if op in "ND":
                chro += n
            if section_end >= Pb:
                return read + Pb - section_end + Lbig
        if op == "I":
            read += n
    return Pb - section_end + Lbig + Lsm


def collect_seed_junctions(res: dict, genome, table: dict,
                           pending: dict | None = None,
                           min_proposers: int = 1) -> None:
    """Seed-only junction events (find_new_junctions seeding once per
    stored candidate result, core.c:3249-3278 + core-junction.c:3836,
    gated by the 3-slot big-margin record :789): entered with support 0
    so they drive scan-2 rescue but only reach .junction.bed once a
    supporter is counted — exactly the reference's event lifecycle
    (events exist from scan 1; write_junction_final_results only emits
    final_counted_reads >= 1)."""
    if pending is None:
        pending = {}
    for pfx in ("seed", "seed2", "seed3"):
        if f"{pfx}_ok" not in res:
            continue
        sel = np.flatnonzero(np.asarray(res[f"{pfx}_ok"], bool))
        if len(sel) == 0:
            continue
        lin_l = np.asarray(res[f"{pfx}_left"], np.int64)
        lin_r = np.asarray(res[f"{pfx}_right"], np.int64)
        donor = np.asarray(res[f"{pfx}_donor"], np.int64)
        cidx, coff_l = genome.linear_to_chro(lin_l)
        cidx_r, coff_r = genome.linear_to_chro(lin_r)
        for i in sel:
            # events are bounded within one chromosome (the reference
            # keys them by a single chro); a pair straddling a contig
            # boundary would seed a bogus cross-contig event
            if int(cidx[i]) != int(cidx_r[i]):
                continue
            key = (
                genome.names[int(cidx[i])], int(coff_l[i]), int(coff_r[i]),
                int(donor[i]),
            )
            n = pending.get(key, 0) + 1
            pending[key] = n
            if n >= min_proposers:
                table.setdefault(key, (0, 0, 0))


def known_junctions_from_annotation(ann) -> dict:
    """-a exon annotation -> preloaded junction events
    (load_known_junctions, core-indel.c:1313 + add_annotation_to_junctions
    :1163): per (gene, chromosome), exons sorted by start; a junction spans
    from the running max exon end to the next exon's start.  Keys use the
    pipeline's (chro, left_edge0, right_edge0, donor_strand) format with
    support 0 — they seed the scan-2 rescue event table but only appear in
    .junction.bed once reads actually support them."""
    out: dict = {}
    by_gene: dict[tuple[int, str], list[tuple[int, int, int]]] = {}
    for i in range(ann.n_features):
        key = (int(ann.feat_gene[i]), ann.feat_chro[i])
        by_gene.setdefault(key, []).append(
            (int(ann.feat_start[i]), int(ann.feat_end[i]),
             int(ann.feat_strand[i]))
        )
    for (_g, chro), exons in by_gene.items():
        exons.sort()
        large_end = -1
        for start, end, strand in exons:
            if 0 < large_end < start:
                # left edge = last exon base, right = first next-exon base
                out[(chro, large_end - 1, start - 1, 1 if strand == 1 else 0)] \
                    = (0, 0, 0)
            large_end = max(large_end, end)
    return out


def junction_event_arrays(
    genome, table: dict
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Sorted (left, right) linear-coordinate arrays for the device
    rescue kernel, plus (left,right)->donor map."""
    lefts, rights, donor = [], [], {}
    name_to_idx = {n: i for i, n in enumerate(genome.names)}
    for (chro, le, re_, ds) in table:
        c = name_to_idx.get(chro)
        if c is None:
            continue
        ll = int(genome.chro_to_linear(c, le))
        rl = int(genome.chro_to_linear(c, re_))
        lefts.append(ll)
        rights.append(rl)
        donor[(ll, rl)] = ds
    if not lefts:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32), donor
    order = np.argsort(lefts)
    return (
        np.asarray(lefts, np.uint32)[order],
        np.asarray(rights, np.uint32)[order],
        donor,
    )


def write_junction_bed(path: str, junctions: dict) -> None:
    """Write the .junction.bed table (write_junction_final_results,
    core-junction.c:4286): BED12-ish rows with flanking block sizes;
    key = (chro, left_edge0, right_edge0, donor_strand), value =
    (n_support, max_left_flank, max_right_flank)."""
    rows = sorted(junctions.items())
    with open(path, "w") as f:
        f.write(
            "#Chr, StartLeftBlock, EndRightBlock, Junction_Name, nSupport, "
            "Strand, StartLeftBlock, EndRightBlock, Color, nBlocks, "
            "BlockSizes, BlockStarts\n"
        )
        for n, ((chro, le, re, dstrand), (sup, ml, mr)) in enumerate(rows, 1):
            start = le - ml + 1
            end = re + mr
            strand = "-" if dstrand else "+"
            color = "0,255,255" if dstrand else "255,0,0"
            f.write(
                f"{chro}\t{start}\t{end}\tJUNC{n:08d}\t{sup}\t{strand}"
                f"\t{start}\t{end}\t{color}\t2\t{ml},{mr}\t0,{re - start}\n"
            )


# narrowing casts applied at device-side result packing (_pack_res) and
# mirrored by the host-side layout (_res_layout): values all fit (mism
# clipped to 999, clips bounded by read length <= 1210)
_PACK_CAST = {"mism": np.int16, "clip_l": np.int16, "clip_r": np.int16}

# device-side probe_kv compaction capacity (reads with an indel/multi-indel
# flag per sub-batch whose [P] section rows ride the packed result buffer;
# sized for ~12% indel-flagged reads per 16K sub-batch before the full-table
# fetch fallback kicks in)
PKV_CAP = 2048


def fetch_result(res: dict) -> dict:
    """device_get of a result dict, excluding the [R, P] probe_kv table —
    that is fetched only when the batch has multi-indel-flagged reads."""
    small = {k: v for k, v in res.items() if k != "probe_kv"}
    out = jax.device_get(small)
    flags = out.get("multi_indel")
    if "probe_kv" in res and flags is not None and flags.any():
        out["probe_kv"] = np.asarray(jax.device_get(res["probe_kv"]))
    return out



def applied_mismatch_limit(max_mismatches, lens):
    """The reference's length-scaled mismatch cap: -M applies per 100bp
    for reads beyond EXON_LONG_READ_LENGTH=160
    (core-junction.c:3359-3362: ((L+1)<<16)/100 * M >> 16)."""
    import jax.numpy as _jnp

    L = lens if isinstance(lens, np.ndarray) else lens
    mod = _jnp if not isinstance(lens, np.ndarray) else np
    # int32-safe: (1211 << 16) * M < 2^31 for M <= 10
    scaled = ((((L.astype(mod.int32) + 1) << 16) // 100)
              * max_mismatches) >> 16
    return mod.where(L > 160, scaled.astype(mod.int32),
                     mod.int32(max_mismatches))


def uniform_length(lens: np.ndarray) -> int | None:
    """The common read length when every (real) read shares it, else None
    — a static hint that turns reverse-complementing into a static flip."""
    nz = lens[lens > 0]
    if len(nz) and (nz == nz[0]).all():
        return int(nz[0])
    return None


class Aligner:
    """Single-chip aligner; the multi-chip variant shards the batch axis."""

    def __init__(self, genome: Genome, index, cfg: AlignConfig):
        # index: a HashIndex or a list of position-range blocks (the
        # memory-bounded split index, index-builder.c -M); votes are
        # accumulated across blocks like read_chunk_circles' per-block
        # voting loop (core.c:3562-3613)
        self.blocks = list(index) if isinstance(index, (list, tuple)) else [index]
        self.genome = genome
        self.index = self.blocks[0]
        self.cfg = cfg
        self.vote_params = VoteParams(
            total_subreads=cfg.total_subreads,
            max_hits=cfg.max_hits_per_probe,
            # device scans handle indels to 16bp (the reference's banded-DP
            # reach); -I beyond that goes to the host long-indel rescue
            # (align.longindel, core-indel.c:4389 analog)
            indel_tolerance=max(min(cfg.max_indel, 16), 1),
            top_k=cfg.top_k,
            index_gap=self.index.index_gap,
            # post-sort candidate-stream cut: valid candidates per read are
            # sparse (chr901 100bp: mean 27 of C=320 columns, 98.5% of
            # reads <= 160), so the window/anchor/top-K passes run on the
            # first 160 sorted entries; denser reads overflow into the
            # saturation-rescue chain which is width-exact (vote.py
            # VoteParams.compact)
            compact=160,
            # narrow cluster-scan window: measured spans on the H=16
            # truncated stream never exceed 16 (chr901); the span-overflow
            # guard in _vote_merged flags any read that would exceed it
            # into the rescue chain, so this is exact at 2/3 the loop cost
            window=16,
        )
        # saturation rescue: reads whose key runs overflow the H-entry
        # gather window re-vote through the same path at a width covering
        # the longest run in the index, so every <=repeat_threshold
        # occurrence is counted exactly like the reference's full bucket
        # scan (sorted-hashtable.c:515-1060)
        max_run = max(getattr(b, "max_run", 0) for b in self.blocks)
        # strictly wider than the longest run, so a full-width run cannot
        # re-trip the truncation flag inside the rescue pass itself
        self.rescue_hits = max(64, -(-(max_run + 1) // 16) * 16)
        self.rescue_vote_params = self.vote_params._replace(
            max_hits=self.rescue_hits,
            # wide-gather candidate streams are denser; measured in-window
            # spans on chr901 repeats peak at 21 — 40 keeps
            # a 2x margin at a third of the old W=64 loop cost
            window=max(self.vote_params.window, 40),
            # the FINAL rescue width must be exact for every read: no cut
            compact=0,
        )
        # device-side rescue fold: saturated reads are compacted ON DEVICE
        # and re-aligned through wider passes inside the same dispatch
        # chain (no host round trip; collect_batch's host rescue only
        # handles overflow beyond the tier capacities).  Two tiers when the
        # full width is much wider than a mid gather: most saturated reads
        # have runs <= 96 (chr901: ~75%), so the expensive full-width pass
        # runs on a quarter of the rows.  Zero tiers when the narrow
        # window already covers every run (no read can saturate).
        import os as _os

        _tier_env = _os.environ.get("SUBREAD_RESCUE_TIER_CAP")
        self.rescue_fold_cap = (
            0 if max_run < cfg.max_hits_per_probe
            else min(4096, cfg.batch_reads)
        )
        if _tier_env is not None:
            self.rescue_fold_cap = min(
                int(_tier_env), self.rescue_fold_cap
            )
        self.rescue_tiers = []
        if self.rescue_fold_cap:
            # mixed-width tier: saturated reads re-vote with the NARROW
            # window on every probe plus up to 8 wide windows on their
            # saturated probes (vote_batch wide_slots) — a saturated read
            # has 1-8 truncated probes in the common case (chr901 16K
            # batch: median 3, 94% <= 8), so this moves ~2.6x less gather
            # volume than re-voting whole reads at the wide width.  Reads
            # with more truncated probes than slots, or whose wide window
            # still truncates, chain into a small full-wide tier; any
            # residue routes to the host pass (measured 0).
            self.rescue_tiers.append((
                self.vote_params._replace(
                    wide_slots=8, wide_hits=self.rescue_hits,
                    # measured spans peak at 21 on chr901 repeats; the
                    # span-overflow guard chains wider reads to tier 2
                    window=32,
                    # tier-1 streams cut at 512 of C=320+8*wide (chr901:
                    # 96% of saturated reads fit); denser reads chain into
                    # the uncut full-wide tier below
                    compact=512,
                ),
                self.rescue_fold_cap,
            ))
            self.rescue_tiers.append((
                # in-chain full-wide tier: candidate streams cut at 1024;
                # denser reads (rare homopolymer pileups) fall through to
                # the host pass, whose rescue_vote_params stay UNCUT
                self.rescue_vote_params._replace(compact=1024),
                max(self.rescue_fold_cap // 8, 256),
            ))
        # device-resident index blocks (replicated single-chip); each block
        # carries its sub-bucket directory (repeat-dense bucket jump table,
        # index.build.build_sub_directory) + its static (sub_bits, steps)
        self.d_blocks = [
            (
                jnp.asarray(b.bucket_start), jnp.asarray(b.comb_rows),
                jnp.asarray(b.sub_dir[0]), jnp.asarray(b.sub_dir[1]),
            )
            for b in self.blocks
        ]
        self.block_meta = [
            (b.bucket_bits, b.sub_dir[2], b.sub_dir[3]) for b in self.blocks
        ]
        (self.d_bucket_start, self.d_comb, self.d_sub_base,
         self.d_sub_lo) = self.d_blocks[0]
        gwords = dna.packed_as_u32(dna.pack_2bit(genome.codes))
        if len(gwords) % 8:
            # pad to an 8-word multiple so genome_window can take its
            # row-gather fast path (free reshape to [Gr, 8] rows)
            gwords = np.pad(gwords, (0, -len(gwords) % 8))
        self.d_genome = jnp.asarray(gwords)
        # contig start offsets (linear positions) for device-side
        # same-chromosome tests (test_PE_and_same_chro, core.c:4819):
        # contig_of(pos) = searchsorted(starts, pos, 'right')
        starts = np.asarray(genome.starts, dtype=np.uint32) if hasattr(
            genome, "starts") else np.zeros(1, np.uint32)
        self.d_contig_starts = jnp.asarray(starts.astype(np.int64))

    # --- device step -------------------------------------------------------
    # Index arrays are jit *arguments* (not closed-over constants): constants
    # would be inlined into the HLO, bloating compiles and defeating the
    # persistent compilation cache.  Scan 1 (vote) and scan 2 (realign) are
    # two separate jits: fusing them into one graph sends XLA's optimizer
    # into a tailspin (>>10min compiles) for no runtime benefit.

    @functools.partial(jax.jit, static_argnames=("self", "L"))
    def _unpack(self, words, amask, L):
        return dna.unpack_reads_device(words, amask, L)

    @functools.partial(jax.jit, static_argnames=("self", "L"))
    def _unpack_na(self, words, L):
        return dna.unpack_reads_device(words, None, L)

    def _device_align(
        self, codes, ambig, lens, bucket_start, comb, sub_base, sub_lo,
        genome_u32, uniform_len=None, rescue=False, vp=None,
    ):
        """Full single-end alignment step: votes + scan-2 selection.

        Returns per-read int arrays (best position, strand, cigar pieces,
        mismatches, mapq, flags related info).  rescue=True re-votes with
        the wide gather (rescue_vote_params, or an explicit vp) for
        saturated reads.
        """
        if vp is None:
            vp = self.rescue_vote_params if rescue else self.vote_params
        bb0, e0, st0 = self.block_meta[0]
        v = vote_batch(
            codes, ambig, lens, bucket_start, comb,
            bb0, vp, static_len=uniform_len,
            sub_base=sub_base, sub_lo=sub_lo, sub_bits=e0, search_steps=st0,
        )
        for (bb, e, st), (d_bs, d_cb, d_sb, d_sl) in zip(
            self.block_meta[1:], self.d_blocks[1:]
        ):
            vb = vote_batch(
                codes, ambig, lens, d_bs, d_cb,
                bb, vp, static_len=uniform_len,
                sub_base=d_sb, sub_lo=d_sl, sub_bits=e, search_steps=st,
            )
            v = self._merge_votes(v, vb)
        res = self._scan2(codes, ambig, lens, genome_u32, v, uniform_len)
        res["saturated"] = v.saturated
        if not rescue and self.rescue_fold_cap:
            res = self._rescue_fold(
                codes, ambig, lens, bucket_start, comb, sub_base, sub_lo,
                genome_u32, res, uniform_len,
            )
        return res

    def _rescue_fold(
        self, codes, ambig, lens, bucket_start, comb, sub_base, sub_lo,
        genome_u32, res, uniform_len,
    ):
        """Device-side saturation rescue: compact the reads whose vote
        gather saturated (first rescue_fold_cap of them), re-align them
        through the wide pass, and scatter the results back — all within
        the submit-side dispatch chain, so the common case costs no host
        round trip (the reference's full bucket scan semantics,
        sorted-hashtable.c:515-1060, at the wide gather width)."""
        for vp, cap in self.rescue_tiers:
            rb = min(cap, codes.shape[0])
            idx_r, valid_r, codes_r, ambig_r, lens_r = self._sat_compact(
                res["saturated"], codes, ambig, lens, rb
            )
            res_r = self._device_align(
                codes_r, ambig_r, lens_r, bucket_start, comb, sub_base,
                sub_lo, genome_u32, uniform_len=uniform_len, rescue=True,
                vp=vp,
            )
            res = self._sat_scatter(res, res_r, idx_r, valid_r)
        return res

    @functools.partial(jax.jit, static_argnames=("self", "rb"))
    def _sat_compact(self, sat, codes, ambig, lens, rb):
        order = jnp.argsort(
            jnp.where(sat, 0, 1), stable=True
        ).astype(jnp.int32)[:rb]
        return (
            order,
            jnp.take(sat, order, axis=0),
            jnp.take(codes, order, axis=0),
            jnp.take(ambig, order, axis=0),
            jnp.take(lens, order, axis=0),
        )

    @functools.partial(jax.jit, static_argnames=("self",))
    def _sat_scatter(self, res, res_r, idx_r, valid_r):
        out = {}
        for k, a in res.items():
            # "saturated" flows through like any key: an intermediate tier's
            # re-saturation flag routes the read to the next (wider) tier;
            # the final tier's gather covers max_run so its flag is False.
            # Overflow rows beyond a tier's capacity keep their flag for
            # the host pass.
            r = res_r.get(k)
            if r is None:
                out[k] = a
                continue
            vr = valid_r
            while vr.ndim < r.ndim:
                vr = vr[..., None]
            out[k] = a.at[idx_r].set(
                jnp.where(vr, r.astype(a.dtype), jnp.take(a, idx_r, axis=0))
            )
        return out

    @functools.partial(jax.jit, static_argnames=("self",))
    def _merge_votes(self, a: VoteResult, b: VoteResult) -> VoteResult:
        return merge_vote_results(a, b, self.vote_params)

    @functools.partial(
        jax.jit, static_argnames=("self", "min_votes", "uniform_len")
    )
    def _score_candidates(self, codes, ambig, lens, genome_u32, v: VoteResult,
                          min_votes: int | None = None,
                          uniform_len: int | None = None):
        """Realignment scoring of every top-K candidate: mismatches via the
        single-indel split scan, plus the reference's integer score
        (core.c:2731-2739).  Returns per-candidate [R, K] arrays."""
        cfg = self.cfg
        R, L = codes.shape
        K = v.pos.shape[1]                # PE widens top_k past the config

        # orient reads once per strand; candidates flattened to one [R*K]
        # batched split-scan call (keeps the compiled graph small).
        fwd = codes
        rev = oriented_read(codes, lens, jnp.ones((R,), jnp.int32), uniform_len)

        si = min(cfg.max_indel, 16)       # device indel reach (see __init__)
        pos_k = v.pos                     # [R, K] uint32
        strand_k = v.strand               # [R, K]
        indel_k = jnp.clip(
            (v.tail - v.pos).astype(jnp.int32), -si, si
        )

        if uniform_len is not None and uniform_len < L:
            # static trim to the common read length: the batch padding
            # columns beyond it only inflate the genome gathers
            fwd, rev = fwd[:, :uniform_len], rev[:, :uniform_len]
        oriented_k = jnp.where(
            strand_k[:, :, None] == 1, rev[:, None, :], fwd[:, None, :]
        )  # [R, K, L']
        flat = lambda a: a.reshape(R * K, *a.shape[2:])
        lens_k = jnp.broadcast_to(lens[:, None], (R, K))
        lens_f = flat(lens_k[:, :, None])[:, 0]
        psi = place_single_indel(
            genome_u32,
            flat(oriented_k),
            lens_f,
            flat(pos_k[:, :, None])[:, 0],
            flat(indel_k[:, :, None])[:, 0],
            max_indel_static=si,
            return_head_prefix="mm",
        )
        split_f, _mism0_f, mm_head_f, mm_tail_f = psi
        # reference final-alignment stats: windowed soft clip from the vote
        # coverage bounds + mismatch/match over the non-clipped M region
        # (find_soft_clipping core-junction.c:2820, final_CIGAR_quality :2899)
        cs_f = flat(v.cov_start[:, :, None])[:, 0]
        ce_f = flat(v.cov_end[:, :, None])[:, 0]
        indel_f = flat(indel_k[:, :, None])[:, 0]
        head_f, tail_f, mism_f, match_f = ref_clip_stats(
            mm_head_f, mm_tail_f, lens_f, split_f, indel_f, cs_f, ce_f,
            show_clip=cfg.show_soft_clipping,
        )
        split_k = split_f.reshape(R, K)
        mism_k = mism_f.reshape(R, K)
        match_k = match_f.reshape(R, K)
        clip_kk = dict(
            clip_l_k=head_f.reshape(R, K),
            clip_r_k=tail_f.reshape(R, K),
            cov_s_k=v.cov_start,
            cov_e_k=v.cov_end,
        )

        votes_k = v.votes
        mv = cfg.min_votes if min_votes is None else min_votes
        valid_k = (votes_k >= mv) & (pos_k != np.uint32(0xFFFFFFFF))

        # realignment score: DNA = match*100000 + (10000 - mismatch)
        # (core.c:2731-2739); match/mismatch are the reference's
        # final_matched/final_mismatched_bases (clip-adjusted)
        score_k = match_k * 100000 + (10000 - mism_k)
        score_k = jnp.where(valid_k, score_k, -1)

        return dict(
            pos_k=pos_k, strand_k=strand_k, indel_k=indel_k, split_k=split_k,
            mism_k=mism_k, match_k=match_k, votes_k=votes_k, valid_k=valid_k,
            score_k=score_k, probe_kv_k=v.probe_kv, anchor_k=v.anchor,
            **clip_kk,
        )

    def _anchor_set(self, sc, min_first: int, max_simples: int = 3,
                    multi_best: int = 3):
        """The reference's scan-2 anchor set from the vote table.

        process_voting_junction_PE_topK (core-junction.c:2199): candidates
        whose vote count is among the top `top_scores`=3 DISTINCT values,
        within max_vote_number_cutoff=2 of the max, capped at
        `max_simples` entries; anchors additionally need >= min_first
        votes (SE branch :2470) and are deduped by position, capped at
        multi_best_reads=3.  Candidates arrive votes-descending from the
        top-K greedy selection, so value tiers are prefix groups.

        Returns (anchor_k bool [R,K], n_anchors int32 [R]).
        """
        votes_k, pos_k = sc["votes_k"], sc["pos_k"]
        apos_k = sc.get("anchor_k", pos_k)  # vote slot position (creation kv)
        has = (votes_k >= 1) & (pos_k != np.uint32(0xFFFFFFFF))
        vmax = votes_k[:, :1]
        newval = jnp.concatenate(
            [jnp.zeros_like(votes_k[:, :1]),
             (votes_k[:, 1:] != votes_k[:, :-1]).astype(votes_k.dtype)],
            axis=1,
        )
        tier = jnp.cumsum(newval, axis=1)
        allowed = has & (tier <= 2) & (votes_k >= vmax - 2)
        slot = jnp.cumsum(allowed.astype(jnp.int32), axis=1)
        simple = allowed & (slot <= max_simples)
        anchor = simple & (votes_k >= min_first)
        # dedup by the vote slot position — the reference compares
        # selected_position (= vote->pos[i][j], the cluster creation kv)
        # across already-stored entries (:2416), strand-blind
        K = votes_k.shape[1]
        eqpos = apos_k[:, :, None] == apos_k[:, None, :]   # [R, K, K]
        earlier = (np.arange(K)[None, :, None] > np.arange(K)[None, None, :])
        dup = jnp.any(eqpos & earlier & anchor[:, None, :], axis=2) & anchor
        anchor = anchor & ~dup
        rank = jnp.cumsum(anchor.astype(jnp.int32), axis=1)
        anchor = anchor & (rank <= multi_best)
        return anchor, jnp.sum(anchor.astype(jnp.int32), axis=1)

    @functools.partial(jax.jit, static_argnames=("self",))
    def _select_se(self, lens, sc):
        """Single-end best-candidate selection + MAPQ (reference scan-2
        semantics: anchors from the vote table, realignment score ranking,
        add_repeated_buffer break-even detection, MAPQ =
        40 / (step2_locations + mismatches), core.c:1448-1452,2731-2775)."""
        cfg = self.cfg
        score_k, valid_k = sc["score_k"], sc["valid_k"]
        anchor_k, n_anchors = self._anchor_set(sc, cfg.min_votes)
        # CORE_TOO_MANY_MISMATCHES + final_MATCH>0 gate (core.c:2689,2749)
        mlim = applied_mismatch_limit(cfg.max_mismatches, lens)[:, None]
        cand_ok = anchor_k & (sc["mism_k"] <= mlim) & (
            sc["match_k"] >= 1
        )
        score_m = jnp.where(cand_ok, score_k, -1)
        best = jnp.argmax(score_m, axis=1)
        take = lambda a: jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
        b_pos, b_strand = take(sc["pos_k"]), take(sc["strand_k"])
        b_indel, b_split = take(sc["indel_k"]), take(sc["split_k"])
        b_mism, b_votes, b_score = take(sc["mism_k"]), take(sc["votes_k"]), take(score_m)
        b_valid = take(cand_ok)
        if "probe_kv_k" in sc:
            b_pkv2 = jnp.take_along_axis(
                sc["probe_kv_k"], best[:, None, None], axis=1
            )[:, 0]
            # the member table covers both strand scans' probes [R, 2*P0];
            # host event placement wants the winner's OWN scan: slice half
            P0 = b_pkv2.shape[1] // 2
            b_pkv = jnp.where(
                b_strand[:, None] == 1, b_pkv2[:, P0:], b_pkv2[:, :P0]
            )
        else:
            b_pkv = None

        mapped = b_valid
        # break-even: a DISTINCT (pos, cigar) alignment ties the best score
        # (add_repeated_buffer core.c:2751 dedups identical pos+cigar)
        cl_k, cr_k = sc["clip_l_k"], sc["clip_r_k"]
        b_cl, b_cr = take(cl_k), take(cr_k)
        same_aln = (
            (sc["pos_k"] == b_pos[:, None])
            & (sc["strand_k"] == b_strand[:, None])
            & (sc["indel_k"] == b_indel[:, None])
            & (sc["split_k"] == b_split[:, None])
            & (cl_k == b_cl[:, None])
            & (cr_k == b_cr[:, None])
        )
        n_best = 1 + jnp.sum(
            (score_m == b_score[:, None]) & cand_ok & ~same_aln, axis=1
        )
        breakeven = mapped & (n_best > 1)
        # MAPQ: 40 / (step2_locations + final_mismatched_bases); 0 on ties
        mapq = jnp.where(
            breakeven, 0,
            cfg.mapq_unique // jnp.maximum(n_anchors + b_mism, 1),
        ).astype(jnp.int32)
        if not cfg.report_multi_mapping and cfg.multi_best <= 1:
            # reference default: break-even reads are not reported
            # (do_iteration_two core.c:2760 highest_score_occurence>=2);
            # -B N implies reporting them with secondaries
            mapped = mapped & ~breakeven
        b_pos0 = b_pos  # unclipped: probe_kv deltas below live in this space
        cl_w = jnp.where(mapped, b_cl, 0)
        cr_w = jnp.where(mapped, b_cr, 0)
        b_pos = jnp.where(mapped, b_pos + cl_w.astype(jnp.uint32), b_pos)
        n_best = jnp.where(breakeven, n_best, 1)
        # Output dtypes are shrunk to the value ranges (fewer fetched
        # bytes).
        out = dict(
            clip_l=cl_w, clip_r=cr_w,
            pos=b_pos, strand=b_strand.astype(jnp.int8),
            indel=b_indel.astype(jnp.int8), split=b_split.astype(jnp.int16),
            mism=jnp.minimum(b_mism, 999).astype(jnp.int16),
            votes=b_votes.astype(jnp.int8), mapped=mapped, multi=n_best > 1,
            mapq=mapq.astype(jnp.int8),
            n_anchors=n_anchors.astype(jnp.int8), best_k=best.astype(jnp.int8),
            cov_start=take(sc["cov_s_k"]).astype(jnp.int16),
            cov_end=take(sc["cov_e_k"]).astype(jnp.int16),
        )
        if b_pkv is not None:
            # multi-indel flag (>=3 distinct probe deltas) computed here so
            # the host only fetches the [R, P] probe_kv table when a batch
            # actually contains flagged reads (rare)
            SEN = np.uint32(0xFFFFFFFF)
            anchored = (b_pos0 != SEN) & (b_votes >= cfg.min_votes)
            validp = (b_pkv != SEN) & anchored[:, None]
            delta = jnp.where(validp, b_pkv - b_pos0[:, None], SEN)
            ds = jnp.sort(delta, axis=1)
            nvalid = validp.sum(axis=1)
            j = np.arange(1, b_pkv.shape[1], dtype=np.int32)[None, :]
            trans = (ds[:, 1:] != ds[:, :-1]) & (j < nvalid[:, None])
            n_distinct = (nvalid > 0).astype(jnp.int32) + trans.sum(axis=1)
            out["multi_indel"] = (n_distinct >= 3) & anchored
            out["probe_kv"] = b_pkv
        if cfg.multi_best > 1:
            # -B N: export the equal-best candidate set so the emitter can
            # report secondary alignments (HI/NH tags, reference
            # write_realignments_for_fragment multi_mapping loop)
            N = min(cfg.multi_best, score_k.shape[1])
            eq = (score_m == b_score[:, None]) & cand_ok
            # order candidates by score so the first N are the ties
            ordk = jnp.argsort(-score_m, axis=1)[:, :N]
            takek = lambda a: jnp.take_along_axis(a, ordk, axis=1)
            out["alt_pos"] = takek(sc["pos_k"])
            out["alt_strand"] = takek(sc["strand_k"]).astype(jnp.int8)
            out["alt_mism"] = jnp.minimum(takek(sc["mism_k"]), 255).astype(jnp.uint8)
            out["alt_indel"] = takek(sc["indel_k"]).astype(jnp.int8)
            out["alt_split"] = takek(sc["split_k"]).astype(jnp.int16)
            out["alt_eq"] = takek(eq)
            out["alt_votes"] = takek(sc["votes_k"]).astype(jnp.int8)
            out["alt_clip"] = jnp.minimum(
                takek(cl_k) + takek(cr_k), 255
            ).astype(jnp.uint8)
        return out

    def _scan2(self, codes, ambig, lens, genome_u32, v: VoteResult,
               uniform_len=None):
        sc = self._score_candidates(codes, ambig, lens, genome_u32, v,
                                    uniform_len=uniform_len)
        if self.cfg.detect_junctions:
            return self._select_se_junc(codes, lens, genome_u32, v, sc,
                                        uniform_len=uniform_len)
        # softclip is folded into _score_candidates/_select_se (per-candidate
        # bounds from the head prefix — no second genome gather or dispatch)
        return self._select_se(lens, sc)

    @functools.partial(jax.jit, static_argnames=("self", "uniform_len"))
    def _apply_softclip(self, codes, lens, genome_u32, res, uniform_len=None):
        """Soft-clip noisy read ends of plain (non-indel) alignments.

        Reference behaviour: soft-clipping is shown by default and the
        mismatch limit applies to the unclipped region (show_soft_cliping /
        find_soft_clipping, gene-algorithms.h:102); -J disables display.
        """
        cfg = self.cfg
        R, L = codes.shape
        oriented = oriented_read(codes, lens, res["strand"], uniform_len)
        if uniform_len is not None and uniform_len < L:
            oriented = oriented[:, :uniform_len]  # static trim (see _score_candidates)
            L = uniform_len
        mm = mismatch_matrix(genome_u32, oriented, lens, res["pos"])
        cl, cr = softclip_bounds(mm, lens)
        skip = (res["indel"] != 0) | (cl + cr >= lens - 16)
        cl = jnp.where(skip, 0, cl)
        cr = jnp.where(skip, 0, cr)
        mmi = mm.astype(jnp.int32)
        pc = jnp.cumsum(mmi, axis=1)  # pc[i] = mism in [0..i]
        total = pc[:, -1]
        head = jnp.where(cl > 0, jnp.take_along_axis(
            pc, jnp.maximum(cl - 1, 0)[:, None], axis=1)[:, 0], 0)
        last_keep = jnp.clip(lens - cr - 1, 0, L - 1)
        upto = jnp.take_along_axis(pc, last_keep[:, None], axis=1)[:, 0]
        mism_clipped = jnp.maximum(upto - head, 0)
        clipped_ok = (res["indel"] == 0) & (mism_clipped <= cfg.max_mismatches)
        valid_pos = res["pos"] != np.uint32(0xFFFFFFFF)
        out = dict(res)
        out["clip_l"] = cl
        out["clip_r"] = cr
        out["mism"] = jnp.where(res["indel"] == 0, mism_clipped, res["mism"])
        out["mapped"] = jnp.where(
            res["indel"] == 0,
            clipped_ok & valid_pos & (res["votes"] >= cfg.min_votes),
            res["mapped"],
        )
        out["pos"] = jnp.where(
            out["mapped"] & (res["indel"] == 0),
            res["pos"] + cl.astype(jnp.uint32), res["pos"],
        )
        return out

    @functools.partial(jax.jit, static_argnames=("self", "uniform_len"))
    def _select_se_junc(self, codes, lens, genome_u32, v: VoteResult, sc,
                        uniform_len=None):
        """SE selection + junction discovery (subjunc mode).

        A junction (head cluster, tail cluster, donor-motif split) replaces
        the plain alignment when it explains the read with fewer mismatches
        (the RNA-seq mismatch-dominant score, core.c:2731-2739).
        """
        from ..ops.junction import (
            big_margin_ambiguous, junction_split_scan, pick_junction_pair,
            pick_stored_seed_junctions,
        )

        cfg = self.cfg
        base = self._select_se(lens, sc)
        pair = pick_junction_pair(v, sc, cfg.max_indel, read_len=lens)
        oriented = oriented_read(codes, lens, base["strand"], uniform_len)
        jr = junction_split_scan(
            genome_u32, oriented, lens, pair["head_pos"], pair["gap"],
            pair["valid"], pair["guess_lo"], pair["guess_hi"],
        )
        mlim = applied_mismatch_limit(cfg.max_mismatches, lens)
        # soft-clip fold for the plain alignment (the reference subjunc
        # clips noisy ends and applies the mismatch limit to the unclipped
        # region, exactly like subread-align — find_soft_clipping).  The
        # junction-vs-plain comparison runs in matched-bases space
        # (finalise_explain_CIGAR picks max matched bases): clipped bases
        # do not count as matched, so plain "cost" = clips + clipped-mism.
        no_ind = base["indel"] == 0
        # base is already clip-folded (pos advanced, mism over the unclipped
        # region) by the new _select_se; cost in lost-matched-bases space
        cl_w = base["clip_l"]
        cr_w = base["clip_r"]
        mc_w = base["mism"].astype(jnp.int32)
        plain_cost = cl_w + cr_w + mc_w
        junc_cost = jr["mism"] + jr["clip_l"] + jr["clip_r"]
        # big-margin junction filter (subjunc default,
        # do_big_margin_filtering_for_junctions core-interface-subjunc.c:278):
        # a read whose major location is vote-ambiguous (other clusters
        # within 1 vote of the best, beyond the junction pair itself)
        # contributes no junction — repeat regions otherwise spray
        # consistent false junctions
        # big-margin junction filter (is_ambiguous_voting,
        # core-junction.c:3522 via find_new_junctions :3856): the EXACT
        # 3-slot big-margin record semantics (insert_big_margin_record
        # :789) — a candidate whose forward-read span matches >1 of the
        # kept records is ambiguous.  Inside a segmental duplication the
        # 3-slot capacity drops one tied half-span, so its twin survives
        # as a singleton and still carries/seeds the junction — the
        # capacity quirk that lets the reference find junctions in
        # repeats while suppressing ordinary repeat reads.
        amb_k = big_margin_ambiguous(v, lens, cfg.min_votes_second)
        best_k_j = jnp.argmax(sc["score_k"], axis=1)
        not_ambiguous = ~jnp.take_along_axis(
            amb_k, best_k_j[:, None], axis=1
        )[:, 0]
        use = pair["valid"] & jr["ok"] & (junc_cost < plain_cost) & (
            jr["mism"] <= cfg.max_mismatches
        ) & not_ambiguous
        out = dict(base)
        # junction reads store pos at the first ALIGNED base (head_pos +
        # clip) and split relative to the clipped region, so the CIGAR is
        # clS (split)M (gap)N (L-cl-split-cr)M crS and the emitters'
        # left_edge = pos0 + split - 1 formula stays exact
        out["pos"] = jnp.where(
            use, pair["head_pos"] + jr["clip_l"].astype(jnp.uint32),
            base["pos"],
        )
        out["mism"] = jnp.where(use, jr["mism"], base["mism"])
        out["mapped"] = base["mapped"] | use
        out["indel"] = jnp.where(use, 0, base["indel"])
        out["split"] = jnp.where(use, jr["split"] - jr["clip_l"],
                                 base["split"])
        out["junc"] = use
        out["junc_gap"] = jnp.where(use, pair["gap"], 0)
        out["junc_donor_strand"] = jr["donor_strand"]
        out["clip_l"] = jnp.where(use, jr["clip_l"], base["clip_l"])
        out["clip_r"] = jnp.where(use, jr["clip_r"], base["clip_r"])
        if cfg.detect_junctions:
            # Event seeding once per STORED candidate (find_new_junctions
            # runs per stored alignment result with the 3-slot big-margin
            # gate, core.c:3249-3278 + core-junction.c:3836/:789; the
            # seeded event then resolves repeat-tied reads in scan 2).
            # Stored candidates can be non-best, so each gets its own
            # split scan.  Plain subread-align batches (detect_junctions
            # off) never pay the three extra split scans or the
            # O(R*K^2) pairwise-compatibility tensor.
            seed = pick_stored_seed_junctions(
                v, sc, cfg.max_indel, lens, sc["valid_k"],
                min_votes=cfg.min_votes,
                min_votes_second=cfg.min_votes_second,
            )
            for s, pfx in enumerate(("seed", "seed2", "seed3")):
                oriented_s = oriented_read(
                    codes, lens, seed["strand"][:, s], uniform_len
                )
                jr_s = junction_split_scan(
                    genome_u32, oriented_s, lens, seed["head_pos"][:, s],
                    seed["gap"][:, s], seed["valid"][:, s],
                    seed["guess_lo"][:, s], seed["guess_hi"][:, s],
                )
                seed_ok = seed["valid"][:, s] & jr_s["ok"] & (
                    jr_s["mism"] <= cfg.max_mismatches
                )
                s_left = (
                    seed["head_pos"][:, s]
                    + jr_s["split"].astype(jnp.uint32) - np.uint32(1)
                )
                out[f"{pfx}_ok"] = seed_ok
                out[f"{pfx}_left"] = s_left
                out[f"{pfx}_right"] = (
                    s_left + seed["gap"][:, s].astype(jnp.uint32)
                    + np.uint32(1)
                )
                out[f"{pfx}_donor"] = jr_s["donor_strand"].astype(jnp.int8)
            # alternate anchor for scan-2 rescue: break-even repeat copies
            # are re-explained at BOTH tied locations (explain_read runs
            # per candidate, core.c:2486); export the best same-strand
            # candidate at a different position.  The best candidate is
            # excluded by INDEX (base["pos"] is soft-clip-advanced, so a
            # raw-position comparison would let the best candidate itself
            # through for clipped reads)
            pos_k, strand_k = sc["pos_k"], sc["strand_k"]
            K = pos_k.shape[1]
            not_best = (
                jnp.arange(K, dtype=jnp.int32)[None, :]
                != base["best_k"].astype(jnp.int32)[:, None]
            )
            alt_valid = (
                sc["valid_k"]
                & not_best
                & (pos_k != base["pos"][:, None])
                & (strand_k == base["strand"].astype(strand_k.dtype)[:, None])
                & (sc["mism_k"] <= mlim[:, None])
            )
            alt_score = jnp.where(alt_valid, sc["score_k"], -1)
            k2 = jnp.argmax(alt_score, axis=1)
            take2 = lambda a: jnp.take_along_axis(a, k2[:, None], axis=1)[:, 0]
            out["alt2_pos"] = take2(pos_k)
            out["alt2_ok"] = take2(alt_score) >= 0
        if self.cfg.all_junctions:
            # export the vote clusters for host-side fusion detection
            # (align/fusion.py; write_fusion_final_results analog)
            out["vk_pos"] = v.pos
            out["vk_strand"] = v.strand
            out["vk_votes"] = v.votes
            out["vk_cov_s"] = v.cov_start
            out["vk_cov_e"] = v.cov_end
        return out

    @functools.partial(jax.jit, static_argnames=("self",))
    def _junction_rescue_step(self, codes, lens, genome_u32, pos, strand,
                              ev_left, ev_right):
        from ..ops.junction import junction_rescue

        oriented = oriented_read(codes, lens, strand)
        return junction_rescue(genome_u32, oriented, lens, pos, ev_left, ev_right)

    def rescue_with_events(self, batch: ReadBatch, res: dict,
                           ev_left: np.ndarray, ev_right: np.ndarray) -> dict:
        """Scan-2 event-table sharing (explain_read, core-junction.c:2617):
        re-explain every anchored read against the global junction table;
        a table junction that explains the read with fewer mismatches (or
        rescues an unmapped read) replaces the plain alignment."""
        cfg = self.cfg
        if len(ev_left) == 0 or "junc" not in res:
            return res
        # pad the event table to a power of two (shape-stable jit)
        E = 1 << max(4, int(np.ceil(np.log2(len(ev_left)))))
        pad = np.full(E - len(ev_left), 0xFFFFFFFF, np.uint32)
        d_left = jnp.asarray(np.concatenate([ev_left, pad]))
        d_right = jnp.asarray(np.concatenate([ev_right, pad]))

        codes, ambig, lens, R = self._pad_batch(batch)
        n = len(lens)
        pos_p = np.full(n, 0xFFFFFFFF, np.uint32)
        # the rescue anchors at the position of the read's FIRST base:
        # a soft-clipped alignment's pos was shifted by clip_l, undo it
        clip_l = np.asarray(res.get("clip_l", np.zeros(R, np.int32)))
        clip_r = np.asarray(res.get("clip_r", np.zeros(R, np.int32)))
        pos_p[:R] = np.where(
            res["pos"] != np.uint32(0xFFFFFFFF),
            res["pos"] - clip_l.astype(np.uint32), res["pos"],
        )
        # vote-tied repeat copies: an unanchored read with a valid alt2
        # funnels the alt anchor into arm 1 (otherwise it has no anchor at
        # all); anchored reads keep their own anchor for arm 1 and try the
        # alternate copy in arm 2 — the event table decides which copy
        # explains the read, exactly like the reference's per-candidate
        # scan-2 explain_read (no smaller-copy preference)
        if "alt2_pos" in res:
            tied0 = (
                np.asarray(res["alt2_ok"], bool)
                & (pos_p[:R] == np.uint32(0xFFFFFFFF))
                & (res["alt2_pos"] != np.uint32(0xFFFFFFFF))
            )
            pos_p[:R] = np.where(tied0, res["alt2_pos"], pos_p[:R])
            res = dict(res)
            res["alt2_pos"] = np.where(
                tied0, np.uint32(0xFFFFFFFF), res["alt2_pos"]
            )
        strand_p = np.zeros(n, np.int32)
        strand_p[:R] = res["strand"]
        bs = cfg.batch_reads
        parts = []
        for i in range(0, n, bs):
            sl = slice(i, i + bs)
            rj = self._junction_rescue_step(
                jnp.asarray(codes[sl]), jnp.asarray(lens[sl]), self.d_genome,
                jnp.asarray(pos_p[sl]), jnp.asarray(strand_p[sl]),
                d_left, d_right,
            )
            parts.append(jax.device_get(rj))
        rj = {k: np.concatenate([p[k] for p in parts])[:R] for k in parts[0]}

        # anchored on the FUNNELED anchor: an unanchored read whose valid
        # alt2 was funneled into pos_p is rescuable at that anchor (the
        # original res["pos"] is the sentinel for those reads)
        anchored = pos_p[:R] != np.uint32(0xFFFFFFFF)
        # costs in matched-bases space: clipped bases are unmatched
        plain_cost = np.asarray(res["mism"]).astype(np.int64) + clip_l + clip_r
        rj_cost = (
            np.asarray(rj["mism"]).astype(np.int64)
            + np.asarray(rj["clip_l"]) + np.asarray(rj["clip_r"])
        )
        accept = (
            rj["ok"] & anchored & ~res["junc"].astype(bool)
            & (rj["mism"] <= cfg.max_mismatches)
            & ((rj_cost + 1 < plain_cost) | ~res["mapped"].astype(bool))
        )
        # second arm: break-even repeat copies re-explained at the OTHER
        # tied location (the reference's scan-2 explain_read runs per
        # candidate; the copy holding the seeded event wins uniquely)
        if "alt2_pos" in res:
            alt_ok = np.asarray(res["alt2_ok"], bool)
            tied = alt_ok & (
                ~np.asarray(res["mapped"], bool)
                | np.asarray(res.get("multi", np.zeros(R, bool)), bool)
            ) & ~np.asarray(res["junc"], bool)
            if tied.any():
                pos2 = np.full(n, 0xFFFFFFFF, np.uint32)
                pos2[:R] = np.where(tied, res["alt2_pos"], np.uint32(0xFFFFFFFF))
                parts2 = []
                for i in range(0, n, bs):
                    sl = slice(i, i + bs)
                    r2 = self._junction_rescue_step(
                        jnp.asarray(codes[sl]), jnp.asarray(lens[sl]),
                        self.d_genome, jnp.asarray(pos2[sl]),
                        jnp.asarray(strand_p[sl]), d_left, d_right,
                    )
                    parts2.append(jax.device_get(r2))
                rj2 = {k: np.concatenate([p[k] for p in parts2])[:R]
                       for k in parts2[0]}
                rj2_cost = (
                    np.asarray(rj2["mism"]).astype(np.int64)
                    + np.asarray(rj2["clip_l"]) + np.asarray(rj2["clip_r"])
                )
                accept2 = (
                    rj2["ok"] & tied & ~accept
                    & (rj2["mism"] <= cfg.max_mismatches)
                    & ((rj2_cost + 1 < plain_cost)
                       | ~res["mapped"].astype(bool))
                )
                for k in ("mism", "split", "gap", "pos", "ok",
                          "clip_l", "clip_r"):
                    rj[k] = np.where(accept2, rj2[k], rj[k])
                # break-even across repeat copies: when BOTH tied anchors
                # explain the read through table events at EQUAL cost and
                # distinct positions, the reference's scan-2 keeps both
                # equal-best candidates and break-even suppresses the read
                # (highest_score_occurence >= 2, core.c:2760) — a segdup
                # twin region where both copies carry seeded events maps
                # nothing.  Revoke the arm-1 acceptance for those rows.
                be = (
                    accept & tied & np.asarray(rj2["ok"], bool)
                    & (rj2["mism"] <= cfg.max_mismatches)
                    & (rj2_cost == (
                        np.asarray(rj["mism"]).astype(np.int64)
                        + np.asarray(rj["clip_l"]) + np.asarray(rj["clip_r"])
                    ))
                    & (np.asarray(rj2["pos"]) != np.asarray(rj["pos"]))
                    # symmetric twin events only (same intron length at
                    # both copies): the segdup signature where the two
                    # explanations are structurally identical and the
                    # reference's equal scores provably tie; asymmetric
                    # pairs break the tie through MATCH/penalty detail
                    & (np.asarray(rj2["gap"]) == np.asarray(rj["gap"]))
                    # and only for reads with NO own anchor quality at all
                    # (pre-rescue unmapped): a multi-flagged read that the
                    # PE weighting still anchored keeps its arm-1 rescue,
                    # matching the reference's PE-weighted combination
                    # scores which break these ties (core-junction.c:2336)
                    & ~np.asarray(res["mapped"], bool)
                )
                accept = (accept | accept2) & ~be
        out = dict(res)
        # an event-table explanation resolves a vote-level tie: only the
        # copy holding the seeded event explains the read, so the read is
        # unique after scan 2 (reference MAPQ = 40/(Nc+Nmm),
        # doc/SubreadUsersGuide.tex:580-592 — Nc counts the candidates)
        was_tied = np.asarray(res.get("multi", np.zeros(R, bool)), bool)
        untied = accept & (was_tied | ~res["mapped"].astype(bool))
        if "multi" in res:
            out["multi"] = np.where(accept, False, was_tied)
        if "mapq" in res and "n_anchors" in res:
            nc = np.asarray(res["n_anchors"], np.int64)
            out["mapq"] = np.where(
                untied,
                cfg.mapq_unique // np.maximum(nc + rj["mism"], 1),
                res["mapq"],
            ).astype(res["mapq"].dtype)
        out["junc"] = np.where(accept, True, res["junc"]).astype(bool)
        out["split"] = np.where(accept, rj["split"], res["split"])
        out["junc_gap"] = np.where(accept, rj["gap"], res["junc_gap"])
        out["mism"] = np.where(accept, rj["mism"], res["mism"])
        out["indel"] = np.where(accept, 0, res["indel"])
        out["mapped"] = res["mapped"] | accept
        # rescued junction records: pos advances past the noisy clipped
        # head (the CIGAR is clS (split-cl)M gapN ... crS) and split is
        # stored relative to the clipped region, like the direct path
        out["pos"] = np.where(
            accept,
            np.asarray(rj["pos"]) + np.asarray(rj["clip_l"]).astype(np.uint32),
            res["pos"],
        )
        out["split"] = np.where(
            accept, rj["split"] - rj["clip_l"], out["split"]
        )
        if "clip_l" in res:
            out["clip_l"] = np.where(accept, rj["clip_l"], res["clip_l"])
            out["clip_r"] = np.where(accept, rj["clip_r"], res["clip_r"])
        # donor strand of a rescued read comes from the event table
        if "junc_donor_strand" in res and hasattr(self, "_ev_donor"):
            le = out["pos"].astype(np.int64) + out["split"].astype(np.int64) - 1
            re_ = le + out["junc_gap"].astype(np.int64) + 1
            ds = out["junc_donor_strand"].copy()
            for i in np.flatnonzero(accept):
                ds[i] = self._ev_donor.get((int(le[i]), int(re_[i])), 0)
            out["junc_donor_strand"] = ds
        return out

    def _reported_mask(self, res) -> np.ndarray:
        """The emit predicate: rows whose record reaches the output as a
        mapped alignment (mapped, in-contig-range, and not suppressed as
        multi-mapping).  Junction-support counting is gated on this so the
        .junction.bed matches the reported records exactly, like the
        reference's write_junction_final_results (core-junction.c:4286)."""
        lin = np.asarray(res["pos"]).astype(np.int64)
        cidx, coff = self.genome.linear_to_chro(lin)
        ok = (
            np.asarray(res["mapped"], bool)
            & (coff >= 0) & (coff < self.genome.lengths[cidx])
        )
        if not self.cfg.report_multi_mapping and "multi" in res:
            ok = ok & ~np.asarray(res["multi"], bool)
        return ok

    def chain_clipped_junctions(self, batch: ReadBatch, res: dict,
                                junctions: dict, events: dict | None = None,
                                count_primary: bool = True,
                                mask: np.ndarray | None = None) -> dict:
        """Multi-junction CIGARs (e.g. the reference's 8M98N74M168N19M):
        a junction read whose clipped end is explained by ANOTHER table
        junction genome-adjacent to its aligned span gets a second N op
        (explain_read walks up to MAX_EVENTS_IN_READ=8 events,
        core-junction.c:2617; here: one extra event per clipped side).
        Host pass over the (rare) clipped junction reads."""
        if events is None:
            events = junctions
        if "junc" not in res or not events:
            return res
        junc = np.asarray(res["junc"], bool)
        if mask is not None:
            junc = junc & np.asarray(mask, bool)
        R = len(junc)
        zeros = np.zeros(R, np.int32)
        cl = np.asarray(res.get("clip_l", zeros))
        cr = np.asarray(res.get("clip_r", zeros))
        cand = np.flatnonzero(junc & ((cl >= 6) | (cr >= 6)))
        if len(cand) == 0:
            return res

        g = self.genome
        name_to_idx = {n: i for i, n in enumerate(g.names)}
        by_right: dict[int, tuple[int, int]] = {}
        by_left: dict[int, tuple[int, int]] = {}
        for (chro, le, re_, ds) in events:
            c = name_to_idx.get(chro)
            if c is None:
                continue
            ll = g.chro_to_linear(c, le)
            rl = g.chro_to_linear(c, re_)
            by_right[rl] = (ll, ds)
            by_left[ll] = (rl, ds)
        overrides = res.get("cigar_override") or {}
        pos_arr = np.asarray(res["pos"]).copy()
        mism_arr = np.asarray(res["mism"], np.int32).copy()
        changed = False
        for i in cand:
            L = int(batch.lengths[i])
            o = batch.codes[i, :L]
            if int(res["strand"][i]):
                o = 3 - o[::-1]
            p0 = int(pos_arr[i])
            ci, cli, cri = int(res["split"][i]), int(cl[i]), int(cr[i])
            gap = int(res["junc_gap"][i])
            tail_m = L - cli - ci - cri
            ci0 = ci  # pre-chain split (the primary junction's geometry)
            parts = [(ci, gap, tail_m)]
            mm_add = 0
            new_pos = p0
            head_cig = tail_cig = None
            if cli >= 6:
                # slack d: the clipped boundary may sit a couple of bases
                # past the true exon edge (the clip bound is heuristic)
                for d in (0, 1, 2):
                    if p0 + d not in by_right or ci - d < 8:
                        continue
                    le2, ds2 = by_right[p0 + d]
                    pre = cli + d
                    s2 = le2 - pre + 1
                    if s2 < 0:
                        continue
                    seg = g.codes[s2 : s2 + pre]
                    mm = int(np.sum(seg != o[:pre]))
                    if mm <= 2:
                        head_cig = (pre, (p0 + d) - le2 - 1)
                        ci -= d
                        new_pos = s2
                        mm_add += mm
                        cidx, coff = g.linear_to_chro(np.asarray([le2]))
                        # key uses contig coords of (le, re)
                        key = (g.names[int(cidx[0])], int(coff[0]),
                               int(coff[0]) + ((p0 + d) - le2), ds2)
                        sup, ml, mr = junctions.get(key, (0, 0, 0))
                        junctions[key] = (sup + 1, max(ml, pre), max(mr, ci))
                        break
            last_base = p0 + ci0 + gap + tail_m - 1
            if cri >= 8 and (last_base in by_left):
                re2, ds2 = by_left[last_base]
                seg = g.codes[re2 : re2 + cri]
                if len(seg) == cri:
                    mm = int(np.sum(seg != o[L - cri:]))
                    if mm <= 2:
                        tail_cig = (re2 - last_base - 1, cri)
                        mm_add += mm
                        cidx, coff = g.linear_to_chro(np.asarray([last_base]))
                        key = (g.names[int(cidx[0])], int(coff[0]),
                               int(coff[0]) + (re2 - last_base), ds2)
                        sup, ml, mr = junctions.get(key, (0, 0, 0))
                        junctions[key] = (sup + 1, max(ml, tail_m), max(mr, cri))
            if head_cig is None and tail_cig is None:
                continue
            if count_primary:
                # the SE emitter skips override reads, so count the read's
                # PRIMARY junction here (it would otherwise lose this
                # support); the PE path counts primaries via
                # collect_junctions instead
                cidx0, coff0 = g.linear_to_chro(np.asarray([p0]))
                key0 = (g.names[int(cidx0[0])], int(coff0[0]) + ci0 - 1,
                        int(coff0[0]) + ci0 + gap,
                        int(res["junc_donor_strand"][i]))
                sup, ml, mr = junctions.get(key0, (0, 0, 0))
                junctions[key0] = (sup + 1, max(ml, ci), max(mr, tail_m))
            cig = ""
            if head_cig is not None:
                cig += f"{head_cig[0]}M{head_cig[1]}N"
            elif cli:
                cig += f"{cli}S"
            cig += f"{ci}M{gap}N{tail_m}M"
            if tail_cig is not None:
                cig += f"{tail_cig[0]}N{tail_cig[1]}M"
            elif cri:
                cig += f"{cri}S"
            mism_arr[i] += mm_add
            pos_arr[i] = new_pos
            overrides[int(i)] = (cig, int(mism_arr[i]), int(mism_arr[i]))
            changed = True
        if not changed:
            return res
        out = dict(res)
        out["pos"] = pos_arr
        out["mism"] = mism_arr
        out["cigar_override"] = overrides
        return out

    @functools.partial(jax.jit, static_argnames=("self",))
    def _select_pe(self, lens1, lens2, sc1, sc2, expected_tlen):
        """Paired-end selection with the reference's exact semantics.

        Scan-1 combos: every candidate pair weighted (V1+V2)*w, w = 1300
        PE-distance / 1000 same chromosome / 800 otherwise (distance only,
        NO orientation test — test_PE_and_same_chro core.c:4819,
        process_voting_junction_PE_topK core-junction.c:2325-2372); top-3
        combos kept, their positions become the per-end anchor sets.

        Scan-2 scoring over all anchor pairs (do_iteration_two
        core.c:2799-2906, DNA): weight 120 PE-distance / 100 same-chro /
        80; SCORE = lexicographic((w*(M1+M2))*1000 - MM1 - MM2,
        999-|tlen-expected|); repeated (pos,cigar) pairs deduped; a
        distinct tie = break-even (dropped unless --multiMapping); MAPQ =
        40/(n_anchors_end + MM_end).  One end without any successful
        realignment → the other scored single-end style (core.c:2707-2788).
        """
        cfg = self.cfg
        R, K = sc1["votes_k"].shape
        v1, v2 = sc1["votes_k"], sc2["votes_k"]
        p1, p2 = sc1["pos_k"], sc2["pos_k"]

        def tier_filter(v, p):
            """The reference's simple-list vote-tier gate
            (process_voting_junction_PE_topK core-junction.c:2261-2290):
            candidates in the top top_scores=3 DISTINCT vote values, within
            max_vote_number_cutoff=2 of the end's max, votes >= min_second.
            Candidates arrive votes-descending so tiers are prefix groups."""
            has = (v >= cfg.min_votes_second) & (p != np.uint32(0xFFFFFFFF))
            newval = jnp.concatenate(
                [jnp.zeros_like(v[:, :1]),
                 (v[:, 1:] != v[:, :-1]).astype(v.dtype)], axis=1)
            tier = jnp.cumsum(newval, axis=1)
            return has & (tier <= 2) & (v >= v[:, :1] - 2)

        val1 = tier_filter(v1, p1)
        val2 = tier_filter(v2, p2)
        cid1 = jnp.searchsorted(self.d_contig_starts,
                                p1.astype(jnp.int64), side="right")
        cid2 = jnp.searchsorted(self.d_contig_starts,
                                p2.astype(jnp.int64), side="right")

        P1 = p1[:, :, None].astype(jnp.int64)
        P2 = p2[:, None, :].astype(jnp.int64)
        V1 = v1[:, :, None].astype(jnp.int32)
        V2 = v2[:, None, :].astype(jnp.int32)
        L1 = lens1[:, None, None].astype(jnp.int64)
        L2 = lens2[:, None, None].astype(jnp.int64)
        same = cid1[:, :, None] == cid2[:, None, :]
        bothv = val1[:, :, None] & val2[:, None, :]

        # scan-1 PE distance: |p1-p2| + rlen of the larger-position read
        tl_vote = jnp.abs(P1 - P2) + jnp.where(P1 > P2, L1, L2)
        pe_vote = same & (tl_vote >= cfg.min_fragment) & (
            tl_vote <= cfg.max_fragment
        )
        mv1 = jnp.maximum(V1, V2)
        mn1 = jnp.minimum(V1, V2)
        eligible = bothv & (mv1 >= cfg.min_votes) & (
            pe_vote | (mn1 >= cfg.min_votes)
        )
        w_vote = jnp.where(pe_vote, 1300, jnp.where(same, 1000, 800))
        adjusted = jnp.where(eligible, (V1 + V2) * w_vote, -1)
        # top max_vote_combinations=3 combos (ties keep the earlier
        # k1-major entry; measured: the reverse-walk storage order does
        # NOT invert tie preference at the reported-record level — the
        # scan-2 realignment rescore settles ties by first-stored)
        KK = K * K
        flat_adj = adjusted.reshape(R, KK)
        fidx = jnp.arange(KK, dtype=jnp.int32)[None, :]
        key = flat_adj * KK + (KK - 1 - fidx)
        key = jnp.where(flat_adj >= 0, key, -1)
        top_key, top_i = jax.lax.top_k(key, 3)            # [R, 3]
        top_ok = top_key >= 0
        tk1 = top_i // K
        tk2 = top_i % K
        any_combo = jnp.any(top_ok, axis=1)

        # per-end anchor sets: positions of the top combos; when no combo
        # exists, the SE-style anchor rule per end (the else branch,
        # core-junction.c:2441-2500)
        def combo_anchor(sc, tk, top_ok):
            onehot = (
                jnp.arange(K, dtype=jnp.int32)[None, None, :] == tk[:, :, None]
            ) & top_ok[:, :, None]
            return jnp.any(onehot, axis=1)                # [R, K]

        a1_combo = combo_anchor(sc1, tk1, top_ok)
        a2_combo = combo_anchor(sc2, tk2, top_ok)
        a1_se, _ = self._anchor_set(sc1, cfg.min_votes)
        a2_se, _ = self._anchor_set(sc2, cfg.min_votes)
        anchor1 = jnp.where(any_combo[:, None], a1_combo, a1_se)
        anchor2 = jnp.where(any_combo[:, None], a2_combo, a2_se)

        # MAPQ divisor: rX_step2_locations = how many bigtable slots this
        # end fills (multi_best_reads=3, load_global_context core.c:4076)
        # = DISTINCT positions among the end's top-3 combo anchors (or the
        # SE-style fallback set), gated by votes >= min_second and slot-0
        # votes >= min_first (core.c:2642,2671; MAPQ adj core.c:2951-2952)
        def distinct_pos_count(anchor, pos):
            eq = pos[:, :, None] == pos[:, None, :]
            earlier = np.arange(K)[None, :, None] > np.arange(K)[None, None, :]
            dup = jnp.any(eq & earlier & anchor[:, None, :], axis=2) & anchor
            return jnp.sum((anchor & ~dup).astype(jnp.int32), axis=1)

        n_anch1 = jnp.minimum(distinct_pos_count(anchor1, p1), 3)
        n_anch2 = jnp.minimum(distinct_pos_count(anchor2, p2), 3)
        # slot 0 holds the end's best candidate; its votes are the
        # max_votes gate for the whole read (core.c:2602,2642)
        vmax1 = jnp.max(jnp.where(anchor1, v1, 0), axis=1)
        vmax2 = jnp.max(jnp.where(anchor2, v2, 0), axis=1)
        n_anch1 = jnp.where(vmax1 >= cfg.min_votes, n_anch1, 0)
        n_anch2 = jnp.where(vmax2 >= cfg.min_votes, n_anch2, 0)

        # realignment success per candidate (CORE_TOO_MANY_MISMATCHES +
        # final_MATCH > 0)
        mlim1 = applied_mismatch_limit(cfg.max_mismatches, lens1)[:, None]
        ok1 = anchor1 & (sc1["mism_k"] <= mlim1) & (
            sc1["match_k"] >= 1
        )
        mlim2 = applied_mismatch_limit(cfg.max_mismatches, lens2)[:, None]
        ok2 = anchor2 & (sc2["mism_k"] <= mlim2) & (
            sc2["match_k"] >= 1
        )
        has1 = jnp.any(ok1, axis=1)
        has2 = jnp.any(ok2, axis=1)

        # ---- scan-2 pair scoring over anchor pairs -----------------------
        M1 = sc1["match_k"][:, :, None].astype(jnp.int32)
        M2 = sc2["match_k"][:, None, :].astype(jnp.int32)
        MM1 = sc1["mism_k"][:, :, None].astype(jnp.int32)
        MM2 = sc2["mism_k"][:, None, :].astype(jnp.int32)
        # chromosomal span ends (calc_end_pos counts leading S + M + D):
        # end = pos0 + L - ins - tail_clip + del; skip = del
        def spans(sc, lens):
            ind = sc["indel_k"].astype(jnp.int64)
            dele = jnp.maximum(ind, 0)
            ins = jnp.maximum(-ind, 0)
            end = sc["pos_k"].astype(jnp.int64) + lens[:, None].astype(
                jnp.int64) - ins - sc["clip_r_k"].astype(jnp.int64) + dele
            return end, dele
        end1, skip1 = spans(sc1, lens1)
        end2, skip2 = spans(sc2, lens2)
        E1 = end1[:, :, None]
        E2 = end2[:, None, :]
        tl2 = jnp.maximum(E1, E2) - jnp.minimum(P1, P2)
        sk = skip1[:, :, None] + skip2[:, None, :]
        # (reference guards each subtraction; combined guard is equivalent
        # for our single-indel cigars where tlen > skips always holds)
        tl2 = jnp.where(tl2 > sk, tl2 - sk, tl2)
        pe2 = same & (tl2 >= cfg.min_fragment) & (tl2 <= cfg.max_fragment)
        w2 = jnp.where(pe2, 120, jnp.where(same, 100, 80))
        primary = (w2 * (M1 + M2)) * 1000 - MM1 - MM2     # < 2^31
        d_tl = jnp.abs(tl2 - expected_tlen.astype(jnp.int64)).astype(jnp.int32)
        tl_sc = jnp.where(pe2 & (d_tl <= 999), 999 - d_tl, 0)
        if cfg.multi_best > 1:
            tl_sc = jnp.zeros_like(tl_sc)  # no TLEN preference with -B
        pair_ok = ok1[:, :, None] & ok2[:, None, :]
        primary = jnp.where(pair_ok, primary, -1)
        # lexicographic max (primary, tl_sc); ties resolve in the
        # reference's scan-2 iteration order, which walks the per-end
        # BIGTABLE entries — stored in combo-score order with position
        # dedup (core-junction.c:2405-2436; comb merge_sort + reversed
        # storage loop) — r1-entry-major (core.c:2799-2906)
        def storage_rank(tk, top_ok, pos):
            BIGR = jnp.int32(9)
            rank = jnp.full(pos.shape, BIGR, jnp.int32)
            cursor = jnp.zeros(pos.shape[0], jnp.int32)
            seen: list = []
            kcol = jnp.arange(K, dtype=jnp.int32)[None, :]
            for c in range(tk.shape[1]):
                kc = tk[:, c]
                okc = top_ok[:, c]
                pc = jnp.take_along_axis(pos, kc[:, None], axis=1)[:, 0]
                dup = jnp.zeros_like(okc)
                for (pp, oo) in seen:
                    dup = dup | ((pp == pc) & oo)
                new = okc & ~dup
                assign = (kcol == kc[:, None]) & new[:, None] & (rank == BIGR)
                rank = jnp.where(assign, cursor[:, None], rank)
                cursor = cursor + new.astype(jnp.int32)
                seen.append((pc, okc))
            return rank

        # bigtable storage order: the comb buffer's sorted insert keeps
        # equal-score combos in GENERATION order, the ascending stable
        # merge_sort preserves that, and the storage loop walks the array
        # BACKWARDS (core-junction.c:2395-2420) — so among tied combos
        # the LAST-generated is stored first.  Re-sort the top-3 columns
        # by (score desc, generation desc) before ranking.
        import os as _os
        if _os.environ.get("SUBREAD_PE_TIE_FWD", "0") != "1":
            # top_key = adj*KK + (KK-1-fidx)  ->  score and generation
            score_c = top_key // jnp.int32(KK)
            gen_c = jnp.int32(KK - 1) - (top_key % jnp.int32(KK))
            colkey = jnp.where(
                top_ok, score_c * jnp.int32(KK) + gen_c, jnp.int32(-1)
            )
            perm = jnp.argsort(-colkey, axis=1)   # [R, 3]
            tk1_s = jnp.take_along_axis(tk1, perm, axis=1)
            tk2_s = jnp.take_along_axis(tk2, perm, axis=1)
            ok_s = jnp.take_along_axis(top_ok, perm, axis=1)
        else:
            tk1_s, tk2_s, ok_s = tk1, tk2, top_ok
        r1_rank = storage_rank(tk1_s, ok_s, p1)
        r2_rank = storage_rank(tk2_s, ok_s, p2)
        # SE-fallback anchor order = candidate order
        kcol = jnp.arange(K, dtype=jnp.int32)[None, :]
        r1_rank = jnp.where(any_combo[:, None], r1_rank, kcol)
        r2_rank = jnp.where(any_combo[:, None], r2_rank, kcol)
        best_p = jnp.max(primary.reshape(R, KK), axis=1)
        at_p = primary == best_p[:, None, None]
        tl_m = jnp.where(at_p, tl_sc, -1)
        best_t = jnp.max(tl_m.reshape(R, KK), axis=1)
        at_best = at_p & (tl_m == best_t[:, None, None])
        rp = r1_rank[:, :, None] * 16 + r2_rank[:, None, :]
        rp_m = jnp.where(at_best, rp, jnp.int32(0x7FFF))
        bi = jnp.argmin(rp_m.reshape(R, KK), axis=1)
        bk1 = (bi // K).astype(jnp.int32)
        bk2 = (bi % K).astype(jnp.int32)
        paired = has1 & has2 & (best_p >= 0)

        # break-even: a DISTINCT (pos1,cigar1,pos2,cigar2) pair ties the
        # best (add_repeated_buffer core.c:2887).  Alignment identity =
        # (pos, strand, indel, split, clips); compared field-wise.
        def same_as_best(sc, kbest):
            eqs = None
            for f in ("pos_k", "strand_k", "indel_k", "split_k",
                      "clip_l_k", "clip_r_k"):
                b = jnp.take_along_axis(sc[f], kbest[:, None], axis=1)
                e = sc[f] == b
                eqs = e if eqs is None else (eqs & e)
            return eqs                                     # [R, K]
        same1 = same_as_best(sc1, bk1)[:, :, None]
        same2 = same_as_best(sc2, bk2)[:, None, :]
        distinct = ~(same1 & same2)
        n_eq = 1 + jnp.sum(
            (at_best & distinct).reshape(R, KK), axis=1
        )
        breakeven = paired & (n_eq > 1)

        # ---- single-end fallbacks (one or both ends unexplained) ---------
        se_score1 = jnp.where(ok1, sc1["score_k"], -1)
        se_score2 = jnp.where(ok2, sc2["score_k"], -1)
        se_k1 = jnp.argmax(se_score1, axis=1).astype(jnp.int32)
        se_k2 = jnp.argmax(se_score2, axis=1).astype(jnp.int32)

        def se_breakeven(sc, score_m, kbest, ok):
            b_s = jnp.take_along_axis(score_m, kbest[:, None], axis=1)
            return jnp.sum(
                (score_m == b_s) & ok & ~same_as_best(sc, kbest), axis=1
            ) > 0

        se_be1 = se_breakeven(sc1, se_score1, se_k1, ok1)
        se_be2 = se_breakeven(sc2, se_score2, se_k2, ok2)

        k1 = jnp.where(paired, bk1, se_k1)
        k2 = jnp.where(paired, bk2, se_k2)
        be1 = jnp.where(paired, breakeven, se_be1)
        be2 = jnp.where(paired, breakeven, se_be2)

        def pick(sc, lens, kk, ok, has, n_anch, be):
            take = lambda a: jnp.take_along_axis(a, kk[:, None], axis=1)[:, 0]
            b_mism = take(sc["mism_k"])
            b_pos = take(sc["pos_k"])
            b_indel = take(sc["indel_k"])
            b_cl = take(sc["clip_l_k"])
            b_cr = take(sc["clip_r_k"])
            mapped = take(ok) & has
            mapq = jnp.where(
                be, 0,
                cfg.mapq_unique // jnp.maximum(
                    n_anch + b_mism.astype(jnp.int32), 1),
            ).astype(jnp.int32)
            if not cfg.report_multi_mapping:
                mapped = mapped & ~be
            cl_w = jnp.where(mapped, b_cl, 0)
            cr_w = jnp.where(mapped, b_cr, 0)
            b_votes = take(sc["votes_k"])
            out = dict(
                clip_l=cl_w, clip_r=cr_w,
                pos=jnp.where(mapped, b_pos + cl_w.astype(jnp.uint32), b_pos),
                strand=take(sc["strand_k"]),
                indel=b_indel, split=take(sc["split_k"]),
                mism=b_mism, votes=b_votes, mapped=mapped,
                multi=be, mapq=mapq,
                n_anchors=n_anch.astype(jnp.int8),
                cov_start=take(sc["cov_s_k"]).astype(jnp.int16),
                cov_end=take(sc["cov_e_k"]).astype(jnp.int16),
            )
            if "probe_kv_k" in sc:
                # per-probe cluster kv of the chosen candidate: drives the
                # event-table indel placement (same export as _select_se)
                b_pkv2 = jnp.take_along_axis(
                    sc["probe_kv_k"], kk[:, None, None], axis=1
                )[:, 0]
                P0h = b_pkv2.shape[1] // 2
                b_pkv = jnp.where(
                    take(sc["strand_k"])[:, None] == 1,
                    b_pkv2[:, P0h:], b_pkv2[:, :P0h],
                )
                SEN = np.uint32(0xFFFFFFFF)
                anchored = (b_pos != SEN) & (b_votes >= cfg.min_votes_second)
                validp = (b_pkv != SEN) & anchored[:, None]
                delta = jnp.where(validp, b_pkv - b_pos[:, None], SEN)
                ds = jnp.sort(delta, axis=1)
                nvalid = validp.sum(axis=1)
                j = np.arange(1, b_pkv.shape[1], dtype=np.int32)[None, :]
                trans = (ds[:, 1:] != ds[:, :-1]) & (j < nvalid[:, None])
                n_distinct = (nvalid > 0).astype(jnp.int32) + trans.sum(axis=1)
                out["multi_indel"] = (n_distinct >= 3) & anchored
                out["probe_kv"] = b_pkv
            return out

        r1 = pick(sc1, lens1, k1, ok1, has1, n_anch1, be1)
        r2 = pick(sc2, lens2, k2, ok2, has2, n_anch2, be2)
        # emission-time proper-pair/TLEN fields are derived on the host
        # (calc_flags/calc_tlen, core.c:1635/1718) from pos+cigar
        r1["best_k"] = k1
        r2["best_k"] = k2
        return r1, r2

    @functools.partial(jax.jit, static_argnames=("self", "uniform_len"))
    def _pe_junction_update(self, codes, lens, genome_u32, v: VoteResult,
                            sc, res, uniform_len=None):
        """Per-mate junction detection on the PE path (subjunc -p):
        the pair-selected candidate anchors the head/tail cluster search,
        otherwise identical to _select_se_junc's junction arm."""
        from ..ops.junction import junction_split_scan, pick_junction_pair

        cfg = self.cfg
        pair = pick_junction_pair(v, sc, cfg.max_indel, best=res["best_k"],
                                  read_len=lens)
        oriented = oriented_read(codes, lens, res["strand"], uniform_len)
        jr = junction_split_scan(
            genome_u32, oriented, lens, pair["head_pos"], pair["gap"],
            pair["valid"], pair["guess_lo"], pair["guess_hi"],
        )
        no_ind = res["indel"] == 0
        cl_w = res.get("clip_l", jnp.zeros_like(res["mism"]))
        cr_w = res.get("clip_r", jnp.zeros_like(res["mism"]))
        plain_cost = jnp.where(no_ind, cl_w + cr_w + res["mism"], res["mism"])
        junc_cost = jr["mism"] + jr["clip_l"] + jr["clip_r"]
        use = pair["valid"] & jr["ok"] & (junc_cost < plain_cost) & (
            jr["mism"] <= cfg.max_mismatches
        ) & ~pair["ambiguous"]
        out = dict(res)
        out["pos"] = jnp.where(
            use, pair["head_pos"] + jr["clip_l"].astype(jnp.uint32),
            res["pos"],
        )
        out["mism"] = jnp.where(use, jr["mism"], res["mism"])
        out["mapped"] = res["mapped"] | use
        out["indel"] = jnp.where(use, 0, res["indel"])
        out["split"] = jnp.where(use, jr["split"] - jr["clip_l"], res["split"])
        out["junc"] = use
        out["junc_gap"] = jnp.where(use, pair["gap"], 0)
        out["junc_donor_strand"] = jr["donor_strand"]
        if "clip_l" in res:
            out["clip_l"] = jnp.where(use, jr["clip_l"], res["clip_l"])
            out["clip_r"] = jnp.where(use, jr["clip_r"], res["clip_r"])
        else:
            out["clip_l"] = jnp.where(use, jr["clip_l"], 0)
            out["clip_r"] = jnp.where(use, jr["clip_r"], 0)
        # per-end stored-candidate event seeding, like _select_se_junc
        # (find_new_junctions runs per stored result per END; the PE
        # simple list is uncapped at our K — max_vote_simples=64,
        # core.c:4077 — so the big-margin record sees every candidate)
        from ..ops.junction import pick_stored_seed_junctions

        seed = pick_stored_seed_junctions(
            v, sc, cfg.max_indel, lens, sc["valid_k"],
            min_votes=cfg.min_votes_second,
            min_votes_second=cfg.min_votes_second,
            max_simples=64,
        )
        for s, pfx in enumerate(("seed", "seed2", "seed3")):
            oriented_s = oriented_read(
                codes, lens, seed["strand"][:, s], uniform_len
            )
            jr_s = junction_split_scan(
                genome_u32, oriented_s, lens, seed["head_pos"][:, s],
                seed["gap"][:, s], seed["valid"][:, s],
                seed["guess_lo"][:, s], seed["guess_hi"][:, s],
            )
            seed_ok = seed["valid"][:, s] & jr_s["ok"] & (
                jr_s["mism"] <= cfg.max_mismatches
            )
            s_left = (
                seed["head_pos"][:, s]
                + jr_s["split"].astype(jnp.uint32) - np.uint32(1)
            )
            out[f"{pfx}_ok"] = seed_ok
            out[f"{pfx}_left"] = s_left
            out[f"{pfx}_right"] = (
                s_left + seed["gap"][:, s].astype(jnp.uint32) + np.uint32(1)
            )
            out[f"{pfx}_donor"] = jr_s["donor_strand"].astype(jnp.int8)
        # alternate anchor for scan-2 rescue (same export as
        # _select_se_junc): break-even repeat copies are re-explained at
        # BOTH tied locations — the host rescue's arm 2 and its
        # break-even revocation need the tied copy's position
        mlim = applied_mismatch_limit(cfg.max_mismatches, lens)
        pos_k, strand_k = sc["pos_k"], sc["strand_k"]
        K = pos_k.shape[1]
        not_best = (
            jnp.arange(K, dtype=jnp.int32)[None, :]
            != res["best_k"].astype(jnp.int32)[:, None]
        )
        alt_valid = (
            sc["valid_k"]
            & not_best
            & (pos_k != res["pos"][:, None])
            & (strand_k == res["strand"].astype(strand_k.dtype)[:, None])
            & (sc["mism_k"] <= mlim[:, None])
        )
        alt_score = jnp.where(alt_valid, sc["score_k"], -1)
        k2 = jnp.argmax(alt_score, axis=1)
        take2 = lambda a: jnp.take_along_axis(a, k2[:, None], axis=1)[:, 0]
        out["alt2_pos"] = take2(pos_k)
        out["alt2_ok"] = take2(alt_score) >= 0
        if cfg.all_junctions:
            # vote clusters for host-side fusion detection, as in
            # _select_se_junc (write_fusion_final_results analog)
            out["vk_pos"] = v.pos
            out["vk_strand"] = v.strand
            out["vk_votes"] = v.votes
            out["vk_cov_s"] = v.cov_start
            out["vk_cov_e"] = v.cov_end
        return out

    def _device_align_pe(
        self, c1, a1, l1, c2, a2, l2, bucket_start, comb, sub_base, sub_lo,
        genome_u32, ul1=None, ul2=None, expected_tlen=None, rescue=False,
        vp=None,
    ):
        B, e0, st0 = self.block_meta[0]
        if vp is None:
            vp = self.rescue_vote_params if rescue else self.vote_params
        # the reference's PE simple lists hold up to 64 candidates per end
        # (max_vote_simples, core.c:4077): inside a 4+-copy segmental
        # duplication the proper-pair candidate can rank below an SE-sized
        # top-K, leaving a perfectly-matching mate unmapped.  Widen the
        # PE candidate list so the PE-distance weighting can resolve it.
        if vp.top_k < 8:
            vp = vp._replace(top_k=8)
        v1 = vote_batch(c1, a1, l1, bucket_start, comb, B, vp,
                        static_len=ul1, sub_base=sub_base, sub_lo=sub_lo,
                        sub_bits=e0, search_steps=st0)
        v2 = vote_batch(c2, a2, l2, bucket_start, comb, B, vp,
                        static_len=ul2, sub_base=sub_base, sub_lo=sub_lo,
                        sub_bits=e0, search_steps=st0)
        # candidate lists for BOTH ends use min_second (the reference's
        # simple-list gate, core-junction.c:2287); min_first gates combos
        # and anchors inside _select_pe
        sc1 = self._score_candidates(
            c1, a1, l1, genome_u32, v1, min_votes=self.cfg.min_votes_second,
            uniform_len=ul1,
        )
        sc2 = self._score_candidates(
            c2, a2, l2, genome_u32, v2, min_votes=self.cfg.min_votes_second,
            uniform_len=ul2,
        )
        if expected_tlen is None:
            expected_tlen = jnp.int32(
                (self.cfg.min_fragment + self.cfg.max_fragment) // 2
            )
        r1, r2 = self._select_pe(l1, l2, sc1, sc2, expected_tlen)
        if self.cfg.detect_junctions:
            r1 = self._pe_junction_update(c1, l1, genome_u32, v1, sc1, r1,
                                          uniform_len=ul1)
            r2 = self._pe_junction_update(c2, l2, genome_u32, v2, sc2, r2,
                                          uniform_len=ul2)
        if not self.cfg.all_junctions:  # fusion detection reads best_k
            r1.pop("best_k", None)
            r2.pop("best_k", None)
        r1["saturated"] = v1.saturated
        r2["saturated"] = v2.saturated
        if not rescue and self.rescue_fold_cap:
            # device-side rescue fold, PE: pairs where EITHER end saturated
            # re-run the wider passes inside the dispatch chain (pair
            # selection mixes both ends' candidate tables, so both records
            # rescatter); a pair stays flagged between tiers while either
            # end's rescue vote re-saturated
            r1["saturated"] = v1.saturated | v2.saturated
            r2["saturated"] = r1["saturated"]
            for tier_vp, cap in self.rescue_tiers:
                sat = r1["saturated"] | r2["saturated"]
                rb = min(cap, c1.shape[0])
                idx_r, valid_r, c1r, a1r, l1r = self._sat_compact(
                    sat, c1, a1, l1, rb
                )
                _, _, c2r, a2r, l2r = self._sat_compact(sat, c2, a2, l2, rb)
                r1r, r2r = self._device_align_pe(
                    c1r, a1r, l1r, c2r, a2r, l2r, bucket_start, comb,
                    sub_base, sub_lo, genome_u32,
                    ul1=ul1, ul2=ul2, expected_tlen=expected_tlen,
                    rescue=True, vp=tier_vp,
                )
                r1["saturated"] = sat
                r2["saturated"] = sat
                r1 = self._sat_scatter(r1, r1r, idx_r, valid_r)
                r2 = self._sat_scatter(r2, r2r, idx_r, valid_r)
        return r1, r2

    # --- host orchestration -------------------------------------------------

    def _pad_batch(self, batch: ReadBatch):
        cfg = self.cfg
        R = len(batch)
        Rp = -(-R // cfg.batch_reads) * cfg.batch_reads if R else cfg.batch_reads
        Lp = max(cfg.pad_read_len, batch.max_len)
        if R == Rp and batch.max_len == Lp:
            # full chunk already reader-padded to the standard width: no copy
            # (~15ms of host numpy per 65K chunk otherwise)
            return (
                np.ascontiguousarray(batch.codes),
                np.ascontiguousarray(batch.ambig),
                batch.lengths.astype(np.int32, copy=False),
                R,
            )
        codes = np.zeros((Rp, Lp), np.uint8)
        ambig = np.zeros((Rp, Lp), bool)
        lens = np.zeros(Rp, np.int32)
        codes[:R, : batch.max_len] = batch.codes
        ambig[:R, : batch.max_len] = batch.ambig
        lens[:R] = batch.lengths
        return codes, ambig, lens, R

    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _iota(self, n):
        """Tuple of n device scalars 0..n-1: per-sub-batch slice indices
        that never touch the host (no host->device scalar upload per
        sub-batch)."""
        ar = jnp.arange(n, dtype=jnp.int32)
        return tuple(ar[i] for i in range(n))

    @functools.partial(jax.jit, static_argnames=("self", "bs", "L"))
    def _prep(self, words_all, lens_all, amask_all, idx, bs, L):
        """Device-side sub-batch slice + unpack from the whole-chunk upload.
        idx is a traced device scalar, so ONE compiled program serves every
        sub-batch (a static index would compile per sub-batch)."""
        row = idx * np.int32(bs)
        words = jax.lax.dynamic_slice_in_dim(words_all, row, bs, axis=0)
        lens = jax.lax.dynamic_slice_in_dim(lens_all, row, bs, axis=0)
        am = (
            None
            if amask_all is None
            else jax.lax.dynamic_slice_in_dim(amask_all, row, bs, axis=0)
        )
        codes, ambig = dna.unpack_reads_device(words, am, L)
        return codes, ambig, lens

    @functools.partial(jax.jit, static_argnames=("self",))
    def _pack_res(self, res):
        """Pack a result dict (minus probe_kv) into ONE uint8 buffer, so
        the fetch is one transfer instead of one per array.  Wide counters
        are narrowed first."""
        bufs = []
        for k in sorted(res):
            if k == "probe_kv":
                continue
            v = res[k]
            tgt = _PACK_CAST.get(k)
            if tgt is not None:
                v = v.astype(tgt)
            if v.dtype == jnp.bool_:
                v = v.astype(jnp.uint8)
            b = jax.lax.bitcast_convert_type(v, jnp.uint8)
            bufs.append(b.reshape(-1))
        return jnp.concatenate(bufs)

    def _res_layout(self, res, bs):
        """(key, np dtype, byte offset, nbytes, was_bool, shape) per packed
        key + total segment bytes; must mirror _pack_res exactly."""
        items = []
        off = 0
        for k in sorted(res):
            if k == "probe_kv":
                continue
            was_bool = res[k].dtype == jnp.bool_
            dt = np.dtype(
                _PACK_CAST.get(k) or (np.uint8 if was_bool else res[k].dtype)
            )
            shape = tuple(res[k].shape)
            nb = dt.itemsize * int(np.prod(shape))
            items.append((k, dt, off, nb, was_bool, shape))
            off += nb
        return items, off

    def align_batch(self, batch: ReadBatch) -> dict[str, np.ndarray]:
        return self.collect_batch(self.submit_batch(batch))

    def submit_batch(self, batch: ReadBatch):
        """Host prep + upload + all device dispatches for one chunk
        (non-blocking beyond the upload).  The whole chunk uploads as one
        packed words tensor, sub-batches are sliced ON
        DEVICE (_prep, traced index), and all sub-batch results come back
        as one packed byte buffer per sub-batch (fetched in collect_batch).
        Splitting submit/collect lets align_file overlap chunk N's host
        postprocess+emit with chunk N+1's device compute."""
        codes, ambig, lens, R = self._pad_batch(batch)
        n = len(lens)
        ul = uniform_length(lens[:R])
        bs = self.cfg.batch_reads
        no_ambig = not ambig.any()  # skip the mask upload for N-free batches
        Lp = codes.shape[1]
        n_sub = n // bs
        words, amask = dna.pack_reads_host(codes, ambig)
        d_words = jnp.asarray(words)
        d_lens = jnp.asarray(lens)
        d_amask = None if no_ambig else jnp.asarray(amask)
        idxs = self._iota(n_sub) if n_sub > 1 else (None,)
        pending = []
        pending_comp = []
        bufs = []
        for j in range(n_sub):
            if n_sub == 1:
                dl = d_lens
                if no_ambig:
                    dc, da = self._unpack_na(d_words, Lp)
                else:
                    dc, da = self._unpack(d_words, d_amask, Lp)
            else:
                dc, da, dl = self._prep(d_words, d_lens, d_amask, idxs[j], bs, Lp)
            res = self._device_align(
                dc, da, dl,
                self.d_bucket_start, self.d_comb, self.d_sub_base,
                self.d_sub_lo, self.d_genome,
                uniform_len=ul,
            )
            pending.append(res)
            comp = (
                self._pkv_compact(
                    res, PKV_CAP, bool_keys=self._bool_keys(res),
                    drop_bestk=not self.cfg.all_junctions,
                )
                if "probe_kv" in res else res
            )
            pending_comp.append(comp)
            bufs.append(self._pack_res(comp))
        if n_sub > 1:
            # ONE chunk-wide fetch: n_sub device->host round trips
            # collapse into one concatenated buffer
            bufs = [self._concat_bufs(tuple(bufs))]
        return pending, pending_comp, bufs, bs, R, n_sub, batch

    @functools.partial(jax.jit, static_argnames=("self",))
    def _concat_bufs(self, bufs):
        return jnp.concatenate(bufs)

    @staticmethod
    def _bool_keys(res) -> tuple:
        """[R]-shaped bool keys of a result dict, sorted — the bitfield
        packing order shared by _pkv_compact and collect_batch."""
        return tuple(sorted(
            k for k, v in res.items()
            if getattr(v, "dtype", None) == jnp.bool_ and v.ndim == 1
        ))

    @functools.partial(
        jax.jit, static_argnames=("self", "cap", "bool_keys", "drop_bestk")
    )
    def _pkv_compact(self, res, cap, bool_keys=(), drop_bestk=False):
        """Shrink the fetched result: (a) replace the [R, P] probe_kv table
        with a device-compacted (indices, rows, count) triple covering the
        reads that host-side event placement actually touches
        (indel-flagged + multi-indel) — these are rare, so the triple rides
        the packed result buffer and the ~0.6MB-per-sub-batch separate
        probe_kv fetch disappears, with a count overflow falling back to
        the full fetch in collect_batch; (b) pack the [R] bool flags into
        one u8 bitfield; (c) drop best_k outside fusion mode (its only
        host consumer)."""
        out = {k: v for k, v in res.items() if k != "probe_kv"}
        if drop_bestk:
            out.pop("best_k", None)
        if bool_keys:
            assert len(bool_keys) <= 16
            bt = jnp.uint8 if len(bool_keys) <= 8 else jnp.uint16
            bits = jnp.zeros(res[bool_keys[0]].shape, bt)
            for i, k in enumerate(bool_keys):
                bits = bits | (out.pop(k).astype(bt) << bt(i))
            out["bflags"] = bits
        flag = res["indel"] != 0
        if "multi_indel" in res:
            flag = flag | res["multi_indel"]
        c = min(cap, flag.shape[0])
        order = jnp.argsort(~flag, stable=True).astype(jnp.int32)[:c]
        out["pkv_idx"] = order
        out["pkv_rows"] = jnp.take(res["probe_kv"], order, axis=0)
        out["pkv_n"] = jnp.sum(flag.astype(jnp.int32))[None]
        return out

    def collect_batch(self, state) -> dict[str, np.ndarray]:
        pending, pending_comp, bufs, bs, R, n_sub, batch = state
        # one single-array fetch per sub-batch (or one chunk-wide buffer
        # from submit_batch): the first waits on compute, later transfers
        # ride under the still-running device queue
        items, seg_len = self._res_layout(pending_comp[0], bs)
        # per-scan probe table width follows the batch read length
        # (applied_subreads: >160bp reads probe more): read it off the
        # packed rows rather than assuming total_subreads
        P = self.vote_params.total_subreads * max(self.index.index_gap, 1)
        for k, dt, off, nb, was_bool, shape in items:
            if k == "pkv_rows":
                P = shape[1]
        parts = []
        if len(bufs) == 1 and n_sub > 1:
            whole = np.array(jax.device_get(bufs[0]))
            segs = [whole[j * seg_len : (j + 1) * seg_len] for j in range(n_sub)]
        else:
            segs = None
        for j in range(n_sub):
            seg = (
                segs[j] if segs is not None
                else np.array(jax.device_get(bufs[j]))
            )  # copy: views must be writable
            d = {}
            for k, dt, off, nb, was_bool, shape in items:
                a = seg[off : off + nb].view(dt).reshape(shape)
                d[k] = a.astype(bool) if was_bool else a
            bf = d.pop("bflags", None)
            if bf is not None:
                for i, k in enumerate(self._bool_keys(pending[j])):
                    d[k] = ((bf >> i) & 1) != 0
            pkv_idx = d.pop("pkv_idx", None)
            pkv_rows = d.pop("pkv_rows", None)
            nf = int(d.pop("pkv_n", [0])[0])
            if pkv_idx is not None and nf > 0:
                if nf <= len(pkv_idx):
                    full = np.full((len(d["pos"]), P), 0xFFFFFFFF, np.uint32)
                    full[pkv_idx[:nf]] = pkv_rows[:nf]
                    d["probe_kv"] = full
                else:
                    # overflow: more flagged reads than the compaction cap
                    d["probe_kv"] = np.asarray(
                        jax.device_get(pending[j]["probe_kv"])
                    )
            parts.append(d)
        out = {}
        for key in parts[0]:
            if key == "probe_kv":
                continue
            out[key] = np.concatenate([p[key] for p in parts])[:R]
        if any("probe_kv" in p for p in parts):
            out["probe_kv"] = np.concatenate([
                p.get("probe_kv",
                      np.zeros((len(p["pos"]), P), np.uint32))
                for p in parts
            ])[:R]
        self._rescue_saturated(batch, out)
        return out

    def _rescue_saturated(self, batch: ReadBatch, out: dict) -> None:
        """Re-align reads whose vote gather saturated (a probe's key run
        overflowed the H-entry window) through the wide rescue pass
        (rescue_vote_params) and overwrite their records in place.  This
        keeps the hot path at the narrow gather width while matching the
        reference's full bucket scan on repeat reads
        (sorted-hashtable.c:515-1060)."""
        sat = out.get("saturated")
        if sat is None or not sat.any():
            return
        idx = np.flatnonzero(sat)
        # small fixed rescue batch: the wide-gather kernel (H=rescue_hits,
        # C=P*H columns) is expensive to compile and run; saturated reads
        # are rare so a 256-row kernel amortises fine
        RB = min(self.cfg.batch_reads, 256)
        Lp = max(self.cfg.pad_read_len, batch.max_len)
        if "probe_kv" in out:
            P = out["probe_kv"].shape[1]
        else:
            P = self.vote_params.total_subreads * max(self.index.index_gap, 1)
        for s in range(0, len(idx), RB):
            ii = idx[s : s + RB]
            codes = np.zeros((RB, Lp), np.uint8)
            ambig = np.zeros((RB, Lp), bool)
            lens = np.zeros(RB, np.int32)
            codes[: len(ii), : batch.max_len] = batch.codes[ii]
            ambig[: len(ii), : batch.max_len] = batch.ambig[ii]
            lens[: len(ii)] = batch.lengths[ii]
            ul = uniform_length(lens[: len(ii)])
            words, amask = dna.pack_reads_host(codes, ambig)
            if ambig.any():
                dc, da = self._unpack(jnp.asarray(words), jnp.asarray(amask), Lp)
            else:
                dc, da = self._unpack_na(jnp.asarray(words), Lp)
            vp = self.rescue_vote_params
            res = self._device_align(
                dc, da, jnp.asarray(lens),
                self.d_bucket_start, self.d_comb, self.d_sub_base,
                self.d_sub_lo, self.d_genome,
                uniform_len=ul, rescue=True, vp=vp,
            )
            # window-escalation backstop: the span-overflow guard
            # (ops/vote.py _vote_merged) re-flags reads whose in-tolerance
            # cluster span exceeds the scan window; double the window until
            # it clears.  256 bounds any repeat-filtered read (<= 63 probes
            # x <= ceil(11/period)+1 same-window occurrences), so the final
            # pass is provably member-complete.
            while vp.window < 256:
                still = np.asarray(
                    jax.device_get(res["saturated"])
                )[: len(ii)]
                if not still.any():
                    break
                vp = vp._replace(window=min(vp.window * 2, 256))
                res = self._device_align(
                    dc, da, jnp.asarray(lens),
                    self.d_bucket_start, self.d_comb, self.d_sub_base,
                    self.d_sub_lo, self.d_genome,
                    uniform_len=ul, rescue=True, vp=vp,
                )
            items, _ = self._res_layout(res, RB)
            seg = np.array(jax.device_get(self._pack_res(res)))
            got_indel = False
            for k, dt, off, nb, was_bool, shape in items:
                a = seg[off : off + nb].view(dt).reshape(shape)
                if was_bool:
                    a = a.astype(bool)
                if k in out:
                    out[k][ii] = a[: len(ii)]
                if k == "indel" and (a[: len(ii)] != 0).any():
                    got_indel = True
            if "probe_kv" in res and (got_indel or "probe_kv" in out):
                if "probe_kv" not in out:
                    out["probe_kv"] = np.full(
                        (len(out["pos"]), P), 0xFFFFFFFF, np.uint32
                    )
                out["probe_kv"][ii] = np.asarray(
                    jax.device_get(res["probe_kv"])
                )[: len(ii)]

    def _emit_sam(
        self,
        writer: samio.SamWriter,
        batch: ReadBatch,
        res: dict[str, np.ndarray],
        summary: AlignSummary,
        junctions: dict | None = None,
        indel_events: dict | None = None,
    ):
        # fast path: native C++ record formatter (subread_tpu/native)
        if (
            junctions is None
            and self.cfg.rg_id is None
            and not self.cfg.ignore_unmapped
            and self.cfg.min_mapped_length <= 0
            and isinstance(writer, samio.SamWriter)
            and self._emit_sam_native(writer, batch, res, summary, indel_events)
        ):
            return
        self._emit_sam_python(writer, batch, res, summary, junctions, indel_events)

    def _emit_multi_read(self, writer, batch, res, i, cidx, coff):
        """-B N multi-best reporting: primary + secondary records with
        HI/NH tags (write_realignments_for_fragment's multi_mapping loop,
        core.c:2383; MAPQ 0, secondaries flagged 0x100)."""
        g = self.genome
        L = int(batch.lengths[i])
        cands = []
        seen = set()
        N = res["alt_pos"].shape[1]
        for j in range(N):
            if not bool(res["alt_eq"][i, j]):
                continue
            lin = int(res["alt_pos"][i, j])
            st = int(res["alt_strand"][i, j])
            if (lin, st) in seen:
                continue
            seen.add((lin, st))
            cands.append((lin, st, int(res["alt_indel"][i, j]),
                          int(res["alt_split"][i, j]),
                          int(res["alt_mism"][i, j])))
        nh = len(cands)
        recs = []
        for hi, (lin, st, indel, split, mism) in enumerate(cands):
            ci2, off2 = g.linear_to_chro(np.asarray([lin], dtype=np.int64))
            off_i = int(off2[0])
            if off_i < 0 or off_i >= int(g.lengths[int(ci2[0])]):
                continue
            seq_codes = batch.codes[i, :L]
            qual = batch.quals[i, :L].tobytes().decode()
            if st == 1:
                seq = dna.decode(dna.revcomp(seq_codes))
                qual = qual[::-1]
            else:
                seq = dna.decode(seq_codes)
            if indel > 0:
                cigar = f"{split}M{indel}D{L - split}M"
            elif indel < 0:
                cigar = f"{split}M{-indel}I{L - split + indel}M"
            else:
                cigar = f"{L}M"
            flag = (samio.FLAG_REVERSE if st else 0) | (0x100 if hi else 0)
            recs.append(samio.SamRecord(
                batch.names[i], flag, g.names[int(ci2[0])], off_i + 1,
                0, cigar, seq=seq, qual=qual,
                tags=[f"HI:i:{hi + 1}", f"NH:i:{nh}",
                      f"NM:i:{mism + abs(indel)}"],
            ))
        for r in recs:
            writer.write(r)
        return len(recs) > 0

    def _emit_sam_native(self, writer, batch, res, summary, indel_events) -> bool:
        from .. import native

        g = self.genome
        n = len(batch)
        lin = res["pos"].astype(np.int64)
        cidx, coff = g.linear_to_chro(lin)
        mapped = (
            np.asarray(res["mapped"], bool)
            & (coff >= 0)
            & (coff < g.lengths[cidx])
        )
        strand = np.asarray(res["strand"], np.int32)
        flags = np.where(mapped, np.where(strand == 1, 16, 0), 4).astype(np.int32)
        indel = np.where(mapped, res["indel"], 0).astype(np.int32)
        nm = (np.asarray(res["mism"], np.int32) + np.abs(indel)).astype(np.int32)
        clip_l = np.asarray(res["clip_l"], np.int32) if "clip_l" in res else None
        clip_r = np.asarray(res["clip_r"], np.int32) if "clip_r" in res else None
        overrides = res.get("cigar_override") or {}
        multi_out = None
        if self.cfg.multi_best > 1 and "alt_pos" in res:
            multi_out = np.asarray(res["multi"], bool) & mapped
        suppress = None
        if overrides or (multi_out is not None and multi_out.any()):
            suppress = np.zeros(n, np.uint8)
            for i in overrides:
                suppress[i] = 1
            if multi_out is not None:
                suppress[multi_out] = 1
        hi = np.ones(n, np.int32)
        nh = np.where(mapped, 1, 0).astype(np.int32)  # SE: tags iff mapped
        blob = native.format_sam_records(
            batch.names,
            batch.codes, batch.quals, batch.lengths.astype(np.int32),
            flags, cidx.astype(np.int32), (coff + 1).astype(np.int32),
            np.asarray(res["mapq"], np.int32), indel,
            np.asarray(res["split"], np.int32), None,
            clip_l, clip_r,
            mapped.astype(np.uint8), nm, g.names,
            suppress=suppress, hi=hi, nh=nh,
        )
        if blob is None:
            return False
        writer.write_bytes(blob)
        if multi_out is not None:
            for i in np.flatnonzero(multi_out):
                self._emit_multi_read(writer, batch, res, int(i), cidx, coff)
        for i, (cigar, mism_i, nm_i) in sorted(overrides.items()):
            if multi_out is not None and multi_out[i]:
                continue
            L = int(batch.lengths[i])
            seq_codes = batch.codes[i, :L]
            qual = batch.quals[i, :L].tobytes().decode()
            if strand[i] == 1:
                seq = dna.decode(dna.revcomp(seq_codes))
                qual = qual[::-1]
            else:
                seq = dna.decode(seq_codes)
            writer.write(samio.SamRecord(
                batch.names[i], int(flags[i]), g.names[int(cidx[i])],
                int(coff[i]) + 1, int(res["mapq"][i]), cigar,
                seq=seq, qual=qual,
                tags=["HI:i:1", "NH:i:1", f"NM:i:{nm_i}"],
            ))
        # summary + indel-event bookkeeping (vectorised / sparse loop)
        summary.total += n
        nm_mapped = int(mapped.sum())
        summary.mapped += nm_mapped
        summary.unmapped += n - nm_mapped
        multi = np.asarray(res["multi"], bool) & mapped
        summary.multi += int(multi.sum())
        summary.unique += nm_mapped - int(multi.sum())
        has_indel = mapped & (indel != 0)
        if overrides:
            for i, (cig_o, _m, _n) in overrides.items():
                has_indel[i] = ("I" in cig_o) or ("D" in cig_o)
        summary.indels += int(has_indel.sum())
        if indel_events is not None:
            done = res.get("_events_done") or ()
            for i in np.flatnonzero(has_indel):
                if i in overrides or i in done:
                    continue  # events recorded by the override producer
                iv = int(indel[i])
                if iv == 0:
                    continue
                sp = int(res["split"][i])
                L = int(batch.lengths[i])
                seq_codes = batch.codes[i, :L]
                if strand[i] == 1:
                    seq = dna.decode(dna.revcomp(seq_codes))
                else:
                    seq = dna.decode(seq_codes)
                ins_seq = seq[sp : sp - iv] if iv < 0 else ""
                key = (int(cidx[i]), int(coff[i]) + sp - 1, iv)
                sup, prev = indel_events.get(key, (0, ins_seq))
                indel_events[key] = (sup + 1, prev)
        return True

    def _emit_sam_python(
        self,
        writer: samio.SamWriter,
        batch: ReadBatch,
        res: dict[str, np.ndarray],
        summary: AlignSummary,
        junctions: dict | None = None,
        indel_events: dict | None = None,
    ):
        g = self.genome
        lin = res["pos"].astype(np.int64)
        cidx, coff = g.linear_to_chro(lin)
        in_contig = (coff >= 0) & (coff < g.lengths[cidx])
        mapped = res["mapped"] & in_contig
        if not self.cfg.report_multi_mapping and self.cfg.multi_best <= 1:
            # -u: multi-mapping reads are reported unmapped (-B N overrides)
            mapped = mapped & ~np.asarray(res["multi"], bool)
        for i, name in enumerate(batch.names):
            L = int(batch.lengths[i])
            strand = int(res["strand"][i])
            seq_codes = batch.codes[i, :L]
            qual = batch.quals[i, :L].tobytes().decode()
            if strand == 1 and mapped[i]:
                seq = dna.decode(dna.revcomp(seq_codes))
                qual = qual[::-1]
            else:
                seq = dna.decode(seq_codes)
            summary.total += 1
            if not mapped[i]:
                summary.unmapped += 1
                if not self.cfg.ignore_unmapped:
                    writer.write(
                        samio.SamRecord(name, samio.FLAG_UNMAPPED, "*", 0, 0,
                                        "*", seq=seq, qual=qual)
                    )
                continue
            summary.mapped += 1
            if res["multi"][i]:
                summary.multi += 1
                if self.cfg.multi_best > 1 and "alt_pos" in res:
                    # -B N: full multi-best record set (HI/NH tags)
                    if self._emit_multi_read(writer, batch, res, i, cidx,
                                             coff):
                        continue
            else:
                summary.unique += 1
            indel = int(res["indel"][i])
            split = int(res["split"][i])
            override = (res.get("cigar_override") or {}).get(i)
            if override is not None:
                cigar, mism_i, nm_i = override
                if "I" in cigar or "D" in cigar:
                    summary.indels += 1
                writer.write(
                    samio.SamRecord(
                        name, samio.FLAG_REVERSE if strand else 0,
                        g.names[int(cidx[i])], int(coff[i]) + 1,
                        int(res["mapq"][i]), cigar, seq=seq, qual=qual,
                        tags=[f"NM:i:{nm_i}"],
                    )
                )
                continue
            if res.get("junc") is not None and res["junc"][i]:
                gap = int(res["junc_gap"][i])
                jcl = int(res.get("clip_l", np.zeros(1, np.int32))[i]) if "clip_l" in res else 0
                jcr = int(res.get("clip_r", np.zeros(1, np.int32))[i]) if "clip_r" in res else 0
                tail_m = L - jcl - split - jcr
                cigar = (
                    (f"{jcl}S" if jcl else "")
                    + f"{split}M{gap}N{tail_m}M"
                    + (f"{jcr}S" if jcr else "")
                )
                if junctions is not None:
                    p0 = int(coff[i])  # 0-based contig pos
                    left_edge = p0 + split - 1
                    right_edge = p0 + split + gap
                    key = (
                        g.names[int(cidx[i])], left_edge, right_edge,
                        int(res["junc_donor_strand"][i]),
                    )
                    sup, ml, mr = junctions.get(key, (0, 0, 0))
                    junctions[key] = (
                        sup + 1, max(ml, split), max(mr, tail_m)
                    )
            elif indel > 0:
                cl = int(res["clip_l"][i]) if "clip_l" in res else 0
                cr = int(res["clip_r"][i]) if "clip_r" in res else 0
                cigar = (
                    (f"{cl}S" if cl else "")
                    + f"{split - cl}M{indel}D{L - split - cr}M"
                    + (f"{cr}S" if cr else "")
                )
                summary.indels += 1
            elif indel < 0:
                ins = -indel
                cl = int(res["clip_l"][i]) if "clip_l" in res else 0
                cr = int(res["clip_r"][i]) if "clip_r" in res else 0
                cigar = (
                    (f"{cl}S" if cl else "")
                    + f"{split - cl}M{ins}I{L - split - ins - cr}M"
                    + (f"{cr}S" if cr else "")
                )
                summary.indels += 1
            else:
                cl = int(res.get("clip_l", np.zeros(1, np.int32))[i]) if "clip_l" in res else 0
                cr = int(res.get("clip_r", np.zeros(1, np.int32))[i]) if "clip_r" in res else 0
                mid = L - cl - cr
                if (0 < self.cfg.min_mapped_length > mid) or (
                    0 < self.cfg.min_mapped_fraction
                    and mid * 100 < self.cfg.min_mapped_fraction * L
                ):
                    # --minMappedLength / --minMappedFraction:
                    # too few mapped bases -> unmapped
                    summary.mapped -= 1
                    summary.unmapped += 1
                    if res["multi"][i]:
                        summary.multi -= 1
                    else:
                        summary.unique -= 1
                    if not self.cfg.ignore_unmapped:
                        writer.write(
                            samio.SamRecord(name, samio.FLAG_UNMAPPED, "*", 0,
                                            0, "*", seq=seq, qual=qual)
                        )
                    continue
                cigar = (f"{cl}S" if cl else "") + f"{mid}M" + (f"{cr}S" if cr else "")
            if indel != 0 and indel_events is not None and (
                i not in (res.get("_events_done") or ())
            ):
                ins_seq = seq[split : split - indel] if indel < 0 else ""
                key = (int(cidx[i]), int(coff[i]) + split - 1, indel)
                sup, prev = indel_events.get(key, (0, ins_seq))
                indel_events[key] = (sup + 1, prev)
            flag = samio.FLAG_REVERSE if strand else 0
            nm = int(res["mism"][i]) + abs(indel)
            tags = ["HI:i:1", "NH:i:1"]
            if self.cfg.rg_id:
                tags.append(f"RG:Z:{self.cfg.rg_id}")
            tags.append(f"NM:i:{nm}")
            writer.write(
                samio.SamRecord(
                    name, flag, g.names[int(cidx[i])], int(coff[i]) + 1,
                    int(res["mapq"][i]), cigar, seq=seq, qual=qual,
                    tags=tags,
                )
            )

    def align_batch_pe(self, b1: ReadBatch, b2: ReadBatch):
        return self.collect_batch_pe(self.submit_batch_pe(b1, b2))

    def submit_batch_pe(self, b1: ReadBatch, b2: ReadBatch):
        """PE variant of the one-upload / packed-single-buffer-fetch loop
        (see submit_batch): both mates upload once per chunk; each sub-batch
        returns one packed byte buffer per mate."""
        c1, a1, l1, R = self._pad_batch(b1)
        c2, a2, l2, _ = self._pad_batch(b2)
        ul1, ul2 = uniform_length(l1[:R]), uniform_length(l2[:R])
        bs = self.cfg.batch_reads
        w1, m1 = dna.pack_reads_host(c1, a1)
        w2, m2 = dna.pack_reads_host(c2, a2)
        na1, na2 = not m1.any(), not m2.any()
        L1, L2 = c1.shape[1], c2.shape[1]
        n_sub = len(l1) // bs
        d_w1, d_w2 = jnp.asarray(w1), jnp.asarray(w2)
        d_l1, d_l2 = jnp.asarray(l1), jnp.asarray(l2)
        d_m1 = None if na1 else jnp.asarray(m1)
        d_m2 = None if na2 else jnp.asarray(m2)
        idxs = self._iota(n_sub) if n_sub > 1 else (None,)
        bufs = []
        for j in range(n_sub):
            if n_sub == 1:
                dl1, dl2 = d_l1, d_l2
                dc1, da1 = (self._unpack_na(d_w1, L1) if na1
                            else self._unpack(d_w1, d_m1, L1))
                dc2, da2 = (self._unpack_na(d_w2, L2) if na2
                            else self._unpack(d_w2, d_m2, L2))
            else:
                dc1, da1, dl1 = self._prep(d_w1, d_l1, d_m1, idxs[j], bs, L1)
                dc2, da2, dl2 = self._prep(d_w2, d_l2, d_m2, idxs[j], bs, L2)
            r1, r2 = self._device_align_pe(
                dc1, da1, dl1, dc2, da2, dl2,
                self.d_bucket_start, self.d_comb, self.d_sub_base,
                self.d_sub_lo, self.d_genome,
                ul1=ul1, ul2=ul2,
            )
            mk = lambda r: (
                self._pkv_compact(r, PKV_CAP, bool_keys=self._bool_keys(r))
                if "probe_kv" in r else r
            )
            c1r, c2r = mk(r1), mk(r2)
            bufs.append((self._pack_res(c1r), self._pack_res(c2r),
                         r1, r2, c1r, c2r))
        return bufs, bs, R, n_sub, b1, b2

    def collect_batch_pe(self, state):
        bufs, bs, R, n_sub, b1, b2 = state
        P = self.vote_params.total_subreads * max(self.index.index_gap, 1)
        if bufs:
            for k, dt, off, nb, was_bool, shape in self._res_layout(
                bufs[0][4], bs
            )[0]:
                if k == "pkv_rows":
                    P = shape[1]
        parts1, parts2 = [], []
        layout = None
        for j in range(n_sub):
            b1d, b2d, r1, r2, c1r, c2r = bufs[j]
            if layout is None:
                layout = (self._res_layout(c1r, bs), self._res_layout(c2r, bs))
            for bufd, (items, _), parts, rdev in (
                (b1d, layout[0], parts1, r1), (b2d, layout[1], parts2, r2),
            ):
                seg = np.array(jax.device_get(bufd))  # copy: views must be writable
                d = {}
                for k, dt, off, nb, was_bool, shape in items:
                    a = seg[off : off + nb].view(dt).reshape(shape)
                    d[k] = a.astype(bool) if was_bool else a
                bf = d.pop("bflags", None)
                if bf is not None:
                    for i, k in enumerate(self._bool_keys(rdev)):
                        d[k] = ((bf >> i) & 1) != 0
                pkv_idx = d.pop("pkv_idx", None)
                pkv_rows = d.pop("pkv_rows", None)
                nf = int(d.pop("pkv_n", [0])[0])
                if pkv_idx is not None and nf > 0:
                    if nf <= len(pkv_idx):
                        full = np.full(
                            (len(d["pos"]), P), 0xFFFFFFFF, np.uint32
                        )
                        full[pkv_idx[:nf]] = pkv_rows[:nf]
                        d["probe_kv"] = full
                    else:
                        d["probe_kv"] = np.asarray(
                            jax.device_get(rdev["probe_kv"])
                        )
                parts.append(d)

        def merge(parts):
            out = {k: np.concatenate([p[k] for p in parts])[:R]
                   for k in parts[0] if k != "probe_kv"}
            if any("probe_kv" in p for p in parts):
                Pm = next(p["probe_kv"].shape[1] for p in parts
                          if "probe_kv" in p)
                out["probe_kv"] = np.concatenate([
                    p.get("probe_kv",
                          np.full((len(p["pos"]), Pm), 0xFFFFFFFF, np.uint32))
                    for p in parts
                ])[:R]
            return out

        out1, out2 = merge(parts1), merge(parts2)
        self._rescue_saturated_pe(b1, b2, out1, out2)
        return out1, out2

    def _rescue_saturated_pe(self, b1, b2, out1: dict, out2: dict) -> None:
        """PE twin of _rescue_saturated: re-align pairs where EITHER end's
        vote gather saturated (pair selection mixes both ends' candidate
        tables, so both records are overwritten)."""
        sat1, sat2 = out1.get("saturated"), out2.get("saturated")
        if sat1 is None or sat2 is None:
            return
        sat = sat1 | sat2
        if not sat.any():
            return
        idx = np.flatnonzero(sat)
        # small fixed rescue batch: the wide-gather kernel (H=rescue_hits,
        # C=P*H columns) is expensive to compile and run; saturated reads
        # are rare so a 256-row kernel amortises fine
        RB = min(self.cfg.batch_reads, 256)
        for s in range(0, len(idx), RB):
            ii = idx[s : s + RB]
            dcs = []
            for b in (b1, b2):
                Lp = max(self.cfg.pad_read_len, b.max_len)
                codes = np.zeros((RB, Lp), np.uint8)
                ambig = np.zeros((RB, Lp), bool)
                lens = np.zeros(RB, np.int32)
                codes[: len(ii), : b.max_len] = b.codes[ii]
                ambig[: len(ii), : b.max_len] = b.ambig[ii]
                lens[: len(ii)] = b.lengths[ii]
                words, amask = dna.pack_reads_host(codes, ambig)
                if ambig.any():
                    dc, da = self._unpack(
                        jnp.asarray(words), jnp.asarray(amask), Lp
                    )
                else:
                    dc, da = self._unpack_na(jnp.asarray(words), Lp)
                dcs.append(
                    (dc, da, jnp.asarray(lens), uniform_length(lens[: len(ii)]))
                )
            (dc1, da1, dl1, ul1), (dc2, da2, dl2, ul2) = dcs
            vp = self.rescue_vote_params
            r1, r2 = self._device_align_pe(
                dc1, da1, dl1, dc2, da2, dl2,
                self.d_bucket_start, self.d_comb, self.d_sub_base,
                self.d_sub_lo, self.d_genome,
                ul1=ul1, ul2=ul2, rescue=True, vp=vp,
            )
            # window-escalation backstop (see _rescue_saturated)
            while vp.window < 256:
                still = (
                    np.asarray(jax.device_get(r1["saturated"]))
                    | np.asarray(jax.device_get(r2["saturated"]))
                )[: len(ii)]
                if not still.any():
                    break
                vp = vp._replace(window=min(vp.window * 2, 256))
                r1, r2 = self._device_align_pe(
                    dc1, da1, dl1, dc2, da2, dl2,
                    self.d_bucket_start, self.d_comb, self.d_sub_base,
                    self.d_sub_lo, self.d_genome,
                    ul1=ul1, ul2=ul2, rescue=True, vp=vp,
                )
            for res, out in ((r1, out1), (r2, out2)):
                items, _ = self._res_layout(res, RB)
                seg = np.array(jax.device_get(self._pack_res(res)))
                for k, dt, off, nb, was_bool, shape in items:
                    a = seg[off : off + nb].view(dt).reshape(shape)
                    if was_bool:
                        a = a.astype(bool)
                    if k in out:
                        out[k][ii] = a[: len(ii)]

    def _pe_record_fields(self, b1, b2, res1, res2):
        """Vectorised per-record PE fields shared by the native formatter
        and the python fallback emitter: FLAG/RNEXT/PNEXT/TLEN/proper-pair
        semantics of the reference's calc_flags/calc_tlen
        (core.c:1659-1683,1718)."""
        g = self.genome
        R = len(b1.names)
        z = np.zeros(R, np.int32)

        def prep(res, batch):
            lin = res["pos"].astype(np.int64)
            cidx, coff = g.linear_to_chro(lin)
            ok = (
                np.asarray(res["mapped"], bool)
                & (coff >= 0) & (coff < g.lengths[cidx])
            )
            if not self.cfg.report_multi_mapping:
                ok = ok & ~np.asarray(res["multi"], bool)
            return cidx.astype(np.int32), coff.astype(np.int64), ok

        c1, o1, ok1 = prep(res1, b1)
        c2, o2, ok2 = prep(res2, b2)
        L1 = b1.lengths.astype(np.int64)
        L2 = b2.lengths.astype(np.int64)
        s1 = np.asarray(res1["strand"], np.int32)
        s2 = np.asarray(res2["strand"], np.int32)

        # ---- calc_tlen (core.c:1718): signed fragment length from the
        # smaller-POS record's CIGAR walk.  Exact closed form for our
        # single-event CIGAR shapes [clS] aM [event] bM [crS]: in the
        # reference walk S consumes BOTH chro and read cursors, so the
        # first section boundary sits at POS + cl + a; if it reaches the
        # larger record's head, TLEN = consumed_read + Pbig - section_end
        # + L_larger, else the walk runs to the end (section_end =
        # POS + Lsm - insertions + deletions + junction gap) and the
        # never-hit fallback equals the end-boundary value.
        def tlen_walk():
            P1p = o1 + 1
            P2p = o2 + 1
            r1_small = P1p <= P2p
            Ps = np.where(r1_small, P1p, P2p)
            Pb = np.where(r1_small, P2p, P1p)
            Lsm = np.where(r1_small, L1, L2)
            Lbig = np.where(r1_small, L2, L1)
            pick = lambda a1, a2: np.where(
                r1_small, np.asarray(a1, np.int64), np.asarray(a2, np.int64)
            )
            ind_s = pick(res1["indel"], res2["indel"])
            spl_s = pick(res1["split"], res2["split"])
            cl_s = pick(res1.get("clip_l", z), res2.get("clip_l", z))
            junc_s = pick(
                res1.get("junc", z), res2.get("junc", z)
            ).astype(bool)
            gap_s = np.zeros(R, np.int64)
            if "junc_gap" in res1:
                gap_s = np.where(
                    junc_s,
                    pick(res1["junc_gap"], res2["junc_gap"]), 0,
                )
            has_event = (ind_s != 0) | (gap_s > 0)
            ins = np.maximum(-ind_s, 0)
            dele = np.maximum(ind_s, 0)
            gap_dn = gap_s + dele
            sec1_end = Ps + cl_s + spl_s
            hit1 = has_event & (sec1_end >= Pb)
            t_hit1 = (cl_s + spl_s) + (Pb - sec1_end) + Lbig
            sec_final = Ps + Lsm - ins + gap_dn
            t_final = Lsm + (Pb - sec_final) + Lbig
            t = np.where(hit1, t_hit1, t_final)
            t = np.where(P1p == P2p, np.maximum(L1, L2), t)
            # multi-event CIGARs (host overrides) get the literal walk
            for res_x, other_first in ((res1, True), (res2, False)):
                ov = res_x.get("cigar_override") or {}
                for i, cig in ov.items():
                    if i >= R:
                        continue
                    small_is_x = (P1p[i] <= P2p[i]) == other_first
                    if not small_is_x:
                        continue
                    t[i] = _calc_tlen_cigar(
                        str(cig), int(Ps[i]), int(Pb[i]), int(Lbig[i]),
                        int(Lsm[i]),
                    )
            # sign: smaller-POS record positive; tie -> R1's strand decides
            tie = P1p == P2p
            neg1 = np.where(tie, s1 == 1, P1p > P2p)
            t1 = np.where(neg1, -t, t)
            t2 = np.where(
                tie, np.where(s1 == 1, t, -t), np.where(P2p > P1p, -t, t)
            )
            return t1.astype(np.int64), t2.astype(np.int64)

        both = ok1 & ok2
        samec = both & (c1 == c2)
        t1_all, t2_all = tlen_walk()
        t1 = np.where(samec, t1_all, 0)
        t2 = np.where(samec, t2_all, 0)
        # proper pair (calc_flags core.c:1659-1683): same chro, |TLEN| in
        # [min,max], SAM strands opposite, forward read leftmost (fr)
        tl_in = (np.abs(t1) >= self.cfg.min_fragment) & (
            np.abs(t1) <= self.cfg.max_fragment
        )
        opp = s1 != s2
        fwd_pos = np.where(s1 == 0, o1, o2)
        rev_pos = np.where(s1 == 0, o2, o1)
        arranged = fwd_pos <= rev_pos
        proper = samec & tl_in & opp & arranged

        def mate_arrays(res, batch, cidx, coff, ok, strand,
                        mok, mcidx, mcoff, mstrand, L_self, L_mate, first,
                        tlen_signed):
            flags = np.full(R, samio.FLAG_PAIRED
                            | (samio.FLAG_FIRST if first else samio.FLAG_SECOND),
                            np.int32)
            flags = np.where(ok, flags, flags | samio.FLAG_UNMAPPED)
            flags = np.where(ok & (strand == 1),
                             flags | samio.FLAG_REVERSE, flags)
            flags = np.where(ok & proper, flags | samio.FLAG_PROPER_PAIR, flags)
            flags = np.where(~mok, flags | samio.FLAG_MATE_UNMAPPED, flags)
            # mate-reverse reflects the mate's strand even when this end is
            # unmapped (reference flag 101/133 records)
            flags = np.where(mok & (mstrand == 1),
                             flags | samio.FLAG_MATE_REVERSE, flags)
            # RNEXT/PNEXT (write_single_fragment core.c:2125-2136):
            # mate unmapped → "*" / 0; both mapped same chro → "=";
            # this end unmapped, mate mapped → mate chro NAME (the "*"
            # pointer differs from the mate's)
            rnext = np.where(
                ~mok, -1,
                np.where(ok & (cidx == mcidx), -2, mcidx),
            ).astype(np.int32)
            pnext = np.where(mok, mcoff + 1, 0).astype(np.int32)
            tlen = np.where(both, tlen_signed, 0).astype(np.int64)
            indel = np.where(ok, np.asarray(res["indel"], np.int32), 0)
            split = np.asarray(res["split"], np.int32)
            cl = np.where(ok, np.asarray(res.get("clip_l", z), np.int32), 0)
            cr = np.where(ok, np.asarray(res.get("clip_r", z), np.int32), 0)
            nm = np.asarray(res["mism"], np.int32) + np.abs(indel)
            mapq = np.asarray(res["mapq"], np.int32)
            junc = (
                np.where(ok, np.asarray(res["junc_gap"], np.int32), 0)
                if "junc_gap" in res else z
            )
            return flags, rnext, pnext, tlen, indel, split, cl, cr, nm, mapq, junc

        m1 = mate_arrays(res1, b1, c1, o1, ok1, s1, ok2, c2, o2, s2,
                         L1, L2, True, t1)
        m2 = mate_arrays(res2, b2, c2, o2, ok2, s2, ok1, c1, o1, s1,
                         L2, L1, False, t2)
        return dict(c1=c1, o1=o1, ok1=ok1, c2=c2, o2=o2, ok2=ok2,
                    m1=m1, m2=m2)

    def _emit_sam_pe_native(self, writer, b1, b2, res1, res2,
                            summary: AlignSummary,
                            indel_events: dict | None = None) -> bool:
        """Vectorised PE record emission through the native formatter
        (mate columns added to format_sam_records); the python fallback
        below formats the same shared fields."""
        from .. import native

        if native.get_lib() is None:
            return False
        # raw-bytes output needs a SAM text sink (BAM writers re-pack
        # records; same gate as the SE fast path) and no RG tagging
        if not isinstance(writer, samio.SamWriter) or self.cfg.rg_id:
            return False
        if res1.get("cigar_override") or res2.get("cigar_override"):
            return False
        g = self.genome
        R = len(b1.names)
        if R == 0:
            return True
        Lmax = max(b1.codes.shape[1], b2.codes.shape[1])
        fl = self._pe_record_fields(b1, b2, res1, res2)
        c1, o1, ok1 = fl["c1"], fl["o1"], fl["ok1"]
        c2, o2, ok2 = fl["c2"], fl["o2"], fl["ok2"]
        m1, m2 = fl["m1"], fl["m2"]

        def interleave(a, b, dtype=None):
            out = np.empty(2 * R, dtype or a.dtype)
            out[0::2] = a
            out[1::2] = b
            return out

        names = [None] * (2 * R)
        names[0::2] = b1.names
        names[1::2] = b2.names
        codes = np.zeros((2 * R, Lmax), np.uint8)
        quals = np.zeros((2 * R, Lmax), np.uint8)
        codes[0::2, : b1.codes.shape[1]] = b1.codes
        codes[1::2, : b2.codes.shape[1]] = b2.codes
        quals[0::2, : b1.quals.shape[1]] = b1.quals
        quals[1::2, : b2.quals.shape[1]] = b2.quals
        lens = interleave(b1.lengths.astype(np.int32),
                          b2.lengths.astype(np.int32))
        okA = interleave(ok1.astype(np.uint8), ok2.astype(np.uint8))
        suppress = None
        if self.cfg.ignore_unmapped:
            suppress = (okA == 0).astype(np.uint8)
        # HI/NH whenever EITHER end of the fragment mapped
        # (write_single_fragment core.c:2047)
        any_ok = ok1 | ok2
        hi = np.ones(2 * R, np.int32)
        nh = interleave(any_ok.astype(np.int32), any_ok.astype(np.int32))
        blob = native.format_sam_records(
            names, codes, quals, lens,
            interleave(m1[0], m2[0]),
            interleave(c1, c2),
            interleave((o1 + 1).astype(np.int32), (o2 + 1).astype(np.int32)),
            interleave(m1[9], m2[9]),
            interleave(m1[4], m2[4]),
            interleave(m1[5], m2[5]),
            interleave(m1[10], m2[10]),
            interleave(m1[6], m2[6]), interleave(m1[7], m2[7]),
            okA, interleave(m1[8], m2[8]),
            g.names, suppress=suppress,
            rnext_cidx=interleave(m1[1], m2[1]),
            pnext=interleave(m1[2], m2[2]),
            tlen=interleave(m1[3], m2[3]),
            hi=hi, nh=nh,
        )
        if blob is None:
            return False
        writer.write_bytes(blob)
        summary.total += 2 * R
        n_ok = int(ok1.sum()) + int(ok2.sum())
        summary.mapped += n_ok
        summary.unmapped += 2 * R - n_ok
        multi = int((np.asarray(res1["multi"], bool) & ok1).sum()) + int(
            (np.asarray(res2["multi"], bool) & ok2).sum()
        )
        summary.multi += multi
        summary.unique += n_ok - multi
        summary.indels += int((ok1 & (m1[4] != 0)).sum()) + int(
            (ok2 & (m2[4] != 0)).sum()
        )
        if indel_events is not None:
            for (batch, res, cidx, coff, ok, ind) in (
                (b1, res1, c1, o1, ok1, m1[4]), (b2, res2, c2, o2, ok2, m2[4]),
            ):
                done = res.get("_events_done") or ()
                for i in np.flatnonzero(ok & (ind != 0)):
                    if i in done:
                        continue  # recorded by the event-placement pass
                    iv = int(ind[i])
                    sp = int(res["split"][i])
                    L = int(batch.lengths[i])
                    codes_i = batch.codes[i, :L]
                    if int(res["strand"][i]):
                        seq = dna.decode(dna.revcomp(codes_i))
                    else:
                        seq = dna.decode(codes_i)
                    ins_seq = seq[sp : sp - iv] if iv < 0 else ""
                    key = (int(cidx[i]), int(coff[i]) + sp - 1, iv)
                    sup, prev = indel_events.get(key, (0, ins_seq))
                    indel_events[key] = (sup + 1, prev)
        return True

    def _emit_sam_pe(self, writer, b1, b2, res1, res2, summary: AlignSummary,
                     indel_events: dict | None = None):
        if self._emit_sam_pe_native(writer, b1, b2, res1, res2, summary,
                                    indel_events):
            return
        g = self.genome
        fl = self._pe_record_fields(b1, b2, res1, res2)
        for i, name in enumerate(b1.names):
            recs = []
            for mate, (batch, res, cidx, coff, ok, m) in enumerate(
                (
                    (b1, res1, fl["c1"], fl["o1"], fl["ok1"], fl["m1"]),
                    (b2, res2, fl["c2"], fl["o2"], fl["ok2"], fl["m2"]),
                )
            ):
                (flags_a, rnext_a, pnext_a, tlen_a, indel_a, split_a,
                 cl_a, cr_a, nm_a, mapq_a, junc_a) = m
                flag = int(flags_a[i])
                L = int(batch.lengths[i])
                seq_codes = batch.codes[i, :L]
                qual = batch.quals[i, :L].tobytes().decode()
                summary.total += 1
                # RNEXT column (codes: -1 "*", -2 "=", else contig index);
                # printed for unmapped ends too (core.c:2140-2164)
                rn = int(rnext_a[i])
                rnext = "*" if rn == -1 else ("=" if rn == -2 else g.names[rn])
                pnext, tlen = int(pnext_a[i]), int(tlen_a[i])
                # HI/NH whenever EITHER end of the fragment mapped
                # (write_single_fragment core.c:2047)
                any_ok = bool(fl["ok1"][i]) or bool(fl["ok2"][i])
                hi_nh = ["HI:i:1", "NH:i:1"] if any_ok else []
                if not ok[i]:
                    summary.unmapped += 1
                    if self.cfg.ignore_unmapped:
                        continue
                    recs.append(
                        samio.SamRecord(name, flag, "*", 0, 0, "*",
                                        rnext=rnext, pnext=pnext, tlen=tlen,
                                        seq=dna.decode(seq_codes), qual=qual,
                                        tags=hi_nh)
                    )
                    continue
                summary.mapped += 1
                if res["multi"][i]:
                    summary.multi += 1
                else:
                    summary.unique += 1
                if flag & samio.FLAG_REVERSE:
                    seq = dna.decode(dna.revcomp(seq_codes))
                    qual = qual[::-1]
                else:
                    seq = dna.decode(seq_codes)
                indel = int(indel_a[i])
                split = int(split_a[i])
                cl, cr, gap = int(cl_a[i]), int(cr_a[i]), int(junc_a[i])
                override = (res.get("cigar_override") or {}).get(i)
                if override is not None:
                    cigar = override[0]
                elif gap > 0:
                    cigar = (
                        (f"{cl}S" if cl else "")
                        + f"{split}M{gap}N{L - cl - split - cr}M"
                        + (f"{cr}S" if cr else "")
                    )
                elif indel > 0:
                    cigar = (
                        (f"{cl}S" if cl else "")
                        + f"{split - cl}M{indel}D{L - split - cr}M"
                        + (f"{cr}S" if cr else "")
                    )
                elif indel < 0:
                    cigar = (
                        (f"{cl}S" if cl else "")
                        + f"{split - cl}M{-indel}I{L - split + indel - cr}M"
                        + (f"{cr}S" if cr else "")
                    )
                else:
                    cigar = (
                        (f"{cl}S" if cl else "")
                        + f"{L - cl - cr}M"
                        + (f"{cr}S" if cr else "")
                    )
                if indel != 0:
                    summary.indels += 1
                    if indel_events is not None and (
                        i not in (res.get("_events_done") or ())
                    ):
                        ins_seq = seq[split : split - indel] if indel < 0 else ""
                        key = (int(cidx[i]), int(coff[i]) + split - 1, indel)
                        sup, prev = indel_events.get(key, (0, ins_seq))
                        indel_events[key] = (sup + 1, prev)
                recs.append(
                    samio.SamRecord(
                        name, flag, g.names[int(cidx[i])], int(coff[i]) + 1,
                        int(mapq_a[i]), cigar, rnext=rnext, pnext=pnext,
                        tlen=tlen, seq=seq, qual=qual,
                        tags=hi_nh + [f"NM:i:{int(nm_a[i])}"],
                    )
                )
            for r in recs:
                writer.write(r)

    def align_file_pe(
        self, fq1: str, fq2: str, out_sam: str, chunk_reads: int = 1 << 20,
        readers=None,
    ) -> AlignSummary:
        summary = AlignSummary()
        rd1, rd2 = readers if readers else (FastqReader(fq1), FastqReader(fq2))
        writer = samio.make_writer(
            out_sam, self.genome.names, [int(x) for x in self.genome.lengths],
            sam_output=self.cfg.sam_output or out_sam.endswith(".sam"),
            sort_by_coordinates=self.cfg.sort_by_coordinates,
            rg_id=self.cfg.rg_id, rg_extra=list(self.cfg.rg_extra) or None,
        )
        junctions: dict | None = {} if self.cfg.detect_junctions else None
        seed_pending: dict = {}
        indel_events: dict = {}
        breakpoints: dict | None = {} if self.cfg.all_junctions else None

        def read_pair():
            b1 = rd1.next_batch(chunk_reads, pad_to=self.cfg.pad_read_len)
            b2 = rd2.next_batch(chunk_reads, pad_to=self.cfg.pad_read_len)
            if b1 is None or b2 is None:
                return None
            assert len(b1) == len(b2), "mate files out of sync"
            return b1, b2

        try:
            t0 = time.time()
            pair = read_pair()
            t_read = time.time() - t0
            state = self.submit_batch_pe(*pair) if pair is not None else None
            while pair is not None:
                # depth-1 chunk pipeline (see align_file)
                t0 = time.time()
                nxt = read_pair()
                t_read_next = time.time() - t0
                nxt_state = self.submit_batch_pe(*nxt) if nxt is not None else None
                t1 = time.time()
                r1, r2 = self.collect_batch_pe(state)
                if junctions is None:
                    # event-table indel placement per end (same shared-event
                    # rule as the SE path; see align_file)
                    from .indelevent import (
                        propose_and_apply, rescue_clipped_with_events,
                    )

                    chunk_events: dict = {}
                    for (bb, rr) in ((pair[0], r1), (pair[1], r2)):
                        if "probe_kv" not in rr:
                            continue
                        ev_new, ev_done = propose_and_apply(
                            self.genome, bb, rr, self.cfg,
                            anchor_mism_limit=self.cfg.max_mismatches,
                            index_gap=self.index.index_gap,
                        )
                        if ev_done:
                            rr["_events_done"] = set(ev_done)
                        for (ss, elen), (sup, iseq) in ev_new.items():
                            chunk_events[(int(ss), int(elen))] = (sup, iseq)
                            ci_e, co_e = self.genome.linear_to_chro(
                                np.asarray([ss], np.int64)
                            )
                            k_e = (int(ci_e[0]), int(co_e[0]), elen)
                            s0, p0 = indel_events.get(k_e, (0, iseq))
                            indel_events[k_e] = (s0 + sup, p0)
                    # record-carried events of BOTH ends also share: a
                    # mate clipped at its partner's indel boundary gets
                    # the event-crossing CIGAR (scan-2 explain_read over
                    # the shared event table, core-indel.c)
                    for (bb, rr) in ((pair[0], r1), (pair[1], r2)):
                        ind = np.asarray(rr["indel"], np.int32)
                        sel = np.flatnonzero(
                            np.asarray(rr["mapped"], bool) & (ind != 0)
                        )
                        pos_a = np.asarray(rr["pos"], np.uint32)
                        spl_a = np.asarray(rr["split"], np.int32)
                        cl_a = np.asarray(rr.get("clip_l", np.zeros_like(ind)))
                        for q in sel:
                            # small side = last M base before the event
                            ss = (
                                int(pos_a[q]) + int(spl_a[q])
                                - int(cl_a[q]) - 1
                            )
                            chunk_events.setdefault(
                                (ss, int(ind[q])), (1, "")
                            )
                    for (bb, rr) in ((pair[0], r1), (pair[1], r2)):
                        rescue_clipped_with_events(
                            self.genome, bb, rr, chunk_events,
                            max_mismatches=self.cfg.max_mismatches,
                        )
                    from .indelevent import rescue_unmapped_mates

                    rescue_unmapped_mates(
                        self.genome, pair[0], pair[1], r1, r2, self.cfg
                    )
                t2 = time.time()
                if junctions is not None:
                    # scan-2 event sharing + chaining, mirroring the SE
                    # path: table junctions (this chunk + earlier chunks +
                    # -a annotations) rescue clipped/unmapped mates
                    prelim = dict(getattr(self, "annot_junctions", None) or {})
                    prelim.update(junctions)
                    collect_junctions(r1, pair[0], self.genome, prelim)
                    collect_junctions(r2, pair[1], self.genome, prelim)
                    collect_seed_junctions(r1, self.genome, prelim,
                                           seed_pending)
                    collect_seed_junctions(r2, self.genome, prelim,
                                           seed_pending)
                    ev_l, ev_r, donor = junction_event_arrays(
                        self.genome, prelim
                    )
                    self._ev_donor = donor
                    r1 = self.rescue_with_events(pair[0], r1, ev_l, ev_r)
                    r2 = self.rescue_with_events(pair[1], r2, ev_l, ev_r)
                    m1 = self._reported_mask(r1)
                    m2 = self._reported_mask(r2)
                    # count_primary: chained rows are skipped by the final
                    # collect_junctions below (their split/junc_gap are
                    # stale), so the chain counts their primary junction
                    # here — in the pre-chain frame, where the ci-M block
                    # genuinely sits
                    r1 = self.chain_clipped_junctions(
                        pair[0], r1, junctions, events=prelim,
                        count_primary=True, mask=m1,
                    )
                    r2 = self.chain_clipped_junctions(
                        pair[1], r2, junctions, events=prelim,
                        count_primary=True, mask=m2,
                    )
                    collect_junctions(r1, pair[0], self.genome, junctions,
                                      mask=m1)
                    collect_junctions(r2, pair[1], self.genome, junctions,
                                      mask=m2)
                if breakpoints is not None:
                    from .fusion import (
                        accumulate_breakpoints, detect_fusion_pairs,
                    )

                    for bb, rr in ((pair[0], r1), (pair[1], r2)):
                        if "vk_pos" not in rr:
                            continue
                        pairs_f = detect_fusion_pairs(
                            rr, bb.lengths, self.cfg.max_indel,
                            batch=bb, genome=self.genome,
                        )
                        accumulate_breakpoints(breakpoints, pairs_f)
                self._emit_sam_pe(writer, pair[0], pair[1], r1, r2, summary,
                                  indel_events)
                t3 = time.time()
                summary.time_io += t_read + (t3 - t2)
                summary.time_voting += t2 - t1
                pair, state, t_read = nxt, nxt_state, t_read_next
        finally:
            rd1.close()
            rd2.close()
            writer.close()
        if junctions is not None:
            write_junction_bed(out_sam + ".junction.bed", junctions)
        if breakpoints is not None:
            from .fusion import write_breakpoints_vcf

            write_breakpoints_vcf(
                out_sam + ".breakpoints.vcf", self.genome, breakpoints
            )
        write_indel_vcf(out_sam + ".indel.vcf", self.genome, indel_events)
        return summary

    def align_file(
        self, fastq_path: str, out_sam: str, chunk_reads: int = 1 << 20,
        reader=None,
    ) -> AlignSummary:
        summary = AlignSummary()
        reader = reader if reader is not None else FastqReader(fastq_path)
        writer = samio.make_writer(
            out_sam,
            self.genome.names,
            [int(x) for x in self.genome.lengths],
            sam_output=self.cfg.sam_output or out_sam.endswith(".sam"),
            sort_by_coordinates=self.cfg.sort_by_coordinates,
            rg_id=self.cfg.rg_id,
            rg_extra=list(self.cfg.rg_extra) or None,
        )
        junctions: dict | None = {} if self.cfg.detect_junctions else None
        seed_pending: dict = {}
        indel_events: dict = {}
        breakpoints: dict | None = {} if self.cfg.all_junctions else None
        try:
            t0 = time.time()
            batch = reader.next_batch(chunk_reads, pad_to=self.cfg.pad_read_len)
            t_read = time.time() - t0
            state = self.submit_batch(batch) if batch is not None else None
            while batch is not None:
                # depth-1 chunk pipeline: read + submit chunk N+1 BEFORE
                # collecting chunk N, so its device compute runs under this
                # chunk's fetch + host postprocess + emit (the device never
                # idles during the ~25ms host prep or the SAM write)
                t0 = time.time()
                nxt = reader.next_batch(chunk_reads, pad_to=self.cfg.pad_read_len)
                t_read_next = time.time() - t0
                nxt_state = self.submit_batch(nxt) if nxt is not None else None
                t1 = time.time()
                res = self.collect_batch(state)
                if junctions is None and "probe_kv" in res:
                    # event-table indel placement: the reference derives
                    # every indel CIGAR from a SHARED event found by its
                    # banded DP (find_new_indels core-indel.c:1831); our
                    # per-read min-mismatch split ties differently inside
                    # homopolymers
                    from .indelevent import propose_and_apply

                    ev_new, ev_done = propose_and_apply(
                        self.genome, batch, res, self.cfg,
                        anchor_mism_limit=self.cfg.max_mismatches,
                        index_gap=self.index.index_gap,
                    )
                    if ev_done:
                        # these rows' events are recorded below; emitters
                        # must not re-derive them from (pos, split)
                        res["_events_done"] = set(ev_done)
                    for (ss, elen), (sup, iseq) in ev_new.items():
                        ci_e, co_e = self.genome.linear_to_chro(
                            np.asarray([ss], np.int64)
                        )
                        k_e = (int(ci_e[0]), int(co_e[0]), elen)
                        s0, p0 = indel_events.get(k_e, (0, iseq))
                        indel_events[k_e] = (s0 + sup, p0)
                if junctions is None and "probe_kv" in res:
                    ov = refine_multi_indels(
                        self.genome, batch, res, self.cfg.max_indel,
                        self.vote_params, self.cfg.max_mismatches,
                        self.cfg.min_votes,
                    )
                    if ov:
                        cur = res.get("cigar_override") or {}
                        cur.update(ov)
                        res["cigar_override"] = cur
                        res["mapped"] = np.asarray(res["mapped"], bool).copy()
                        res["mapq"] = np.asarray(res["mapq"], np.int32).copy()
                        res["mism"] = np.asarray(res["mism"], np.int32).copy()
                        for i, (_c, mm, _nm) in ov.items():
                            res["mapped"][i] = True
                            res["mism"][i] = mm
                            if res["mapq"][i] <= 0:
                                res["mapq"][i] = self.cfg.mapq_unique // (1 + mm)
                if junctions is None and self.cfg.max_indel > 16:
                    # iteration three: long indels via soft-clip re-anchoring
                    from .longindel import rescue_long_indels

                    if not hasattr(self, "_ins_piles"):
                        self._ins_piles = {}
                    ov2, ev2, _ = rescue_long_indels(
                        self.genome, batch, res, self.cfg.max_indel,
                        piles=self._ins_piles,
                    )
                    if ov2:
                        cur = res.get("cigar_override") or {}
                        for i, v_ in ov2.items():
                            cur.setdefault(i, v_)
                        res["cigar_override"] = cur
                        res["mism"] = np.asarray(res["mism"], np.int32).copy()
                        for i, (_c, mm, _nm) in ov2.items():
                            res["mism"][i] = mm
                        for k, (sup, ins) in ev2.items():
                            s0, p0 = indel_events.get(k, (0, ins))
                            indel_events[k] = (s0 + sup, p0)
                if junctions is not None:
                    # scan-2 event-table sharing: junctions discovered in
                    # this chunk (plus all earlier chunks, plus -a annotated
                    # junctions) rescue reads without their own minor cluster
                    prelim = dict(getattr(self, "annot_junctions", None) or {})
                    prelim.update(junctions)
                    collect_junctions(res, batch, self.genome, prelim)
                    collect_seed_junctions(res, self.genome, prelim,
                                           seed_pending)
                    ev_l, ev_r, donor = junction_event_arrays(
                        self.genome, prelim
                    )
                    self._ev_donor = donor
                    res = self.rescue_with_events(batch, res, ev_l, ev_r)
                    # chain lookups use the full event set (prelim) but
                    # support counts land in the output table (junctions)
                    res = self.chain_clipped_junctions(
                        batch, res, junctions, events=prelim,
                        mask=self._reported_mask(res),
                    )
                t2 = time.time()
                if breakpoints is not None and "vk_pos" in res:
                    from .fusion import accumulate_breakpoints, detect_fusion_pairs

                    pairs = detect_fusion_pairs(
                        res, batch.lengths, self.cfg.max_indel,
                        batch=batch, genome=self.genome,
                    )
                    accumulate_breakpoints(breakpoints, pairs)
                self._emit_sam(writer, batch, res, summary,
                               junctions=junctions, indel_events=indel_events)
                t3 = time.time()
                summary.time_io += t_read + (t3 - t2)
                summary.time_voting += t2 - t1  # vote+realign fused on device
                batch, state, t_read = nxt, nxt_state, t_read_next
        finally:
            reader.close()
            writer.close()
        if junctions is not None:
            write_junction_bed(out_sam + ".junction.bed", junctions)
        if breakpoints is not None:
            from .fusion import write_breakpoints_vcf

            write_breakpoints_vcf(
                out_sam + ".breakpoints.vcf", self.genome, breakpoints
            )
        if getattr(self, "_ins_piles", None):
            # cross-read reassembly of insertions longer than any single
            # read's clip (finalise_long_insertions, core-indel.c:4389)
            from .longindel import assemble_insertion_piles

            for k, (sup, ins) in assemble_insertion_piles(
                self.genome, self._ins_piles, self.cfg.max_indel
            ).items():
                s0, p0 = indel_events.get(k, (0, ins))
                indel_events[k] = (s0 + sup, p0)
            self._ins_piles = {}
        write_indel_vcf(out_sam + ".indel.vcf", self.genome, indel_events)
        return summary


def refine_multi_indels(
    genome: Genome, batch: ReadBatch, res: dict, max_indel: int,
    vote_params: VoteParams, max_mismatches: int = 3, min_votes: int = 3,
) -> dict[int, tuple[str, int, int]]:
    """Exact multi-indel CIGARs for reads whose winning vote cluster has
    three or more distinct probe offsets (the indel_recorder walk of
    find_new_indels, core-indel.c:1874-1906, done host-side for the rare
    flagged reads).  Returns {read_idx: (cigar, mismatches, nm)} for reads
    where the multi-indel explanation beats the single-indel one."""
    if "probe_kv" not in res:
        return {}
    pkv = res["probe_kv"].astype(np.int64)          # [R, P]
    pos = res["pos"].astype(np.int64)
    SEN = np.int64(np.uint32(0xFFFFFFFF))
    # a multi-indel read usually FAILS the single-indel mismatch gate
    # (one merged event leaves a shifted middle segment), so the flag is
    # vote anchoring, not the final mapped bit
    anchored = (pos != SEN) & (np.asarray(res["votes"]) >= min_votes)
    valid = (pkv != SEN) & anchored[:, None]
    delta = np.where(valid, pkv - pos[:, None], 0)
    if "multi_indel" in res:
        # flags were computed on device (_select_se)
        flagged = np.flatnonzero(np.asarray(res["multi_indel"], bool))
    else:
        # distinct deltas per read among valid probes, vectorised (a python
        # per-read loop here costs more than the whole device step)
        big = np.int64(1) << 62
        ds = np.sort(np.where(valid, delta, big), axis=1)
        nvalid = valid.sum(axis=1)
        j = np.arange(1, ds.shape[1])[None, :]
        trans = (ds[:, 1:] != ds[:, :-1]) & (j < nvalid[:, None])
        n_distinct = (nvalid > 0).astype(np.int32) + trans.sum(axis=1)
        flagged = np.flatnonzero((n_distinct >= 3) & anchored)
    if len(flagged) == 0:
        return {}

    out: dict[int, tuple[str, int, int]] = {}
    KMER = 16
    for r in flagged:
        L = int(batch.lengths[r])
        strand = int(res["strand"][r])
        codes = batch.codes[r, :L]
        oriented = dna.revcomp(codes) if strand == 1 else codes
        p0 = int(pos[r])
        # probe walk in read order: sections of equal delta.  kv for
        # reverse-strand clusters was computed at the mirrored offset
        # o' = L - KMER - o in the oriented (revcomp) read.
        # probe_kv rows are already the winner's OWN strand scan (the
        # two-grid probes read the reversed read at the same offset grid),
        # so the offsets apply without mirroring
        po = _probe_offsets_host(L, vote_params)
        P = min(pkv.shape[1], len(po))
        pairs = [
            (int(po[p]), int(delta[r, p]))
            for p in range(P)
            if valid[r, p]
        ]
        pairs.sort()
        sections = []
        for off, d in pairs:
            if not sections or sections[-1][2] != d:
                sections.append([off, off, d])
            else:
                sections[-1][1] = off
        # require monotone plausible steps
        ok = all(
            abs(sections[i + 1][2] - sections[i][2]) <= max_indel
            for i in range(len(sections) - 1)
        )
        if len(sections) < 3 or not ok:
            continue
        gwin = lambda s, e, shift: _genome_codes(genome, p0 + shift + s, e - s)
        splits = []
        total_mism = 0
        prev_split = 0
        feasible = True
        for i in range(len(sections) - 1):
            lo = sections[i][1] + 1              # after last probe of sec i
            hi = min(sections[i + 1][0] + KMER - 1, L - 1)
            lo = max(lo, prev_split + 1)
            if lo > hi:
                feasible = False
                break
            d_before, d_after = sections[i][2], sections[i + 1][2]
            # choose split s in [lo, hi] minimising local mismatches
            g_before = gwin(lo, hi, d_before)
            g_after = gwin(lo, hi, d_after)
            seg = oriented[lo:hi]
            mm_b = (seg != g_before[: len(seg)]).astype(np.int32)
            mm_a = (seg != g_after[: len(seg)]).astype(np.int32)
            # cost(s) = before-mism in [lo, s) + after-mism in [s, hi)
            pref = np.concatenate(([0], np.cumsum(mm_b)))
            suff = np.concatenate((np.cumsum(mm_a[::-1])[::-1], [0]))
            s_local = int(np.argmin(pref + suff))
            splits.append((lo + s_local, d_after - d_before))
            prev_split = lo + s_local
        if not feasible or not splits:
            continue
        # assemble CIGAR (M segments between splits; D consumes genome,
        # I consumes read) and recount mismatches over the M segments
        cig = []
        nm = 0
        read_cursor = 0
        ok = True
        for s, d in splits + [(L, 0)]:
            seg_len = s - read_cursor
            if seg_len <= 0:
                ok = False
                break
            cig.append((seg_len, "M"))
            read_cursor += seg_len
            if d > 0:
                cig.append((d, "D"))
                nm += d
            elif d < 0:
                ins = min(-d, L - read_cursor)
                if ins <= 0:
                    ok = False
                    break
                cig.append((ins, "I"))
                nm += ins
                read_cursor += ins
        if not ok or read_cursor != L:
            continue
        mism = 0
        read_cursor = 0
        gpos = p0
        for n_, op in cig:
            if op == "M":
                g = _genome_codes(genome, gpos, n_)
                mism += int(
                    (oriented[read_cursor : read_cursor + n_] != g[:n_]).sum()
                )
                read_cursor += n_
                gpos += n_
            elif op == "D":
                gpos += n_
            elif op == "I":
                read_cursor += n_
        if mism > max_mismatches:
            continue
        was_mapped = bool(res["mapped"][r])
        if was_mapped and mism + len(splits) >= int(res["mism"][r]) + (
            1 if int(res["indel"][r]) else 0
        ):
            continue  # single-indel explanation is as good — keep it
        cigar = "".join(f"{n_}{op}" for n_, op in cig)
        out[int(r)] = (cigar, mism, mism + nm)
    return out


def _probe_offsets_host(L: int, params: VoteParams) -> np.ndarray:
    """Host mirror of ops.vote.static_offsets for one read length
    (includes the >160bp applied-subread ladder)."""
    from ..ops.vote import static_offsets

    return static_offsets(L, params).astype(np.int64)


def _genome_codes(genome: Genome, start: int, n: int) -> np.ndarray:
    start = max(int(start), 0)
    return genome.codes[start : start + n]
