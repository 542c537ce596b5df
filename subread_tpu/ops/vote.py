"""Seed-and-vote: batched vote-gather over the sorted 16-mer hash index.

This is the dense-batch re-design of the reference's hottest loop,
`gehash_go_q`/`gehash_go_X` (sorted-hashtable.c:515-1060) driven from
`do_voting` (core.c:3049-3323).  The reference fills a tiny per-read hash
"vote table" (30x24) as hits stream out of bucket binary searches; that
shape is intrinsically scalar.  Here the same semantics are recast as
dense fixed-shape tensor ops over a whole read batch:

  1. probe extraction  — evenly spaced 16-mers per read (core.c:3115-3184)
  2. hash gather       — per-probe bucket binary search (branchless,
                         fixed trip count) + fixed-width hit gather
  3. vote counting     — all candidate positions kv = hit_pos - probe_offset
                         are sorted per read; for every candidate anchor the
                         number of *distinct* probes within [kv, kv+tol] is
                         counted with a sliding windowed OR of probe bitmasks
                         + popcount (= the vote-table clustering with
                         indel tolerance, sorted-hashtable.c:1007-1060)
  4. top-K selection   — greedy max-vote anchors with same-cluster
                         suppression (process_voting_junction_PE_topK
                         semantics, core-junction.c:2199)

Everything is jit-compatible: static shapes, lax control flow only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

KMER = 16
SENTINEL = np.uint32(0xFFFFFFFF)  # numpy, not jnp: a trace-time constant


class VoteParams(NamedTuple):
    total_subreads: int = 10      # 10 DNA-seq / 14 RNA-seq (core-indel.c:4473)
    max_hits: int = 32            # bucket-window width per probe (GENE_VOTE_SPACE analog)
    indel_tolerance: int = 5      # cluster tolerance (max indel length, -I)
    window: int = 24              # max cluster candidates scanned per anchor
    #                               (the reference's own vote rows cap at
    #                               GENE_VOTE_SPACE=24 slots per 5bp band,
    #                               subread.h:217; measured spans on chr901
    #                               peak at 16 within +-tol)
    top_k: int = 4                # candidate clusters kept per read
    index_gap: int = 1            # 1 = full index (-F), 3 = gapped
    wide_slots: int = 0           # mixed rescue: per-read count of
    #                               saturated probes re-gathered at
    #                               wide_hits width (0 = plain pass)
    wide_hits: int = 0
    compact: int = 0              # post-sort candidate-stream cut: the
    #                               window/anchor/top-K passes run on the
    #                               first `compact` sorted entries only
    #                               (valid candidates sort before the
    #                               SENTINEL padding, so this is lossless
    #                               for reads with <= compact candidates;
    #                               reads with more overflow into the
    #                               saturation-rescue path).  0 = full C.


class VoteResult(NamedTuple):
    """Per-read top-K vote clusters; arrays [R, K] (probe_kv [R, K, P]).

    Candidates are ordered exactly as the reference's simple-list scan
    emits them (process_voting_junction_PE_topK, core-junction.c:2262-2310):
    vote count descending (level), then vote-table row (kv/5) % 30
    ascending, then slot creation order within the row (= arrival order of
    the cluster's first hit in the strand-major probe scan), then kv.
    This ordering is observable: it caps the simple list (max_vote_simples),
    feeds the MAPQ candidate count, and breaks equal-score ties."""

    pos: jnp.ndarray        # uint32 position implied by the head section
    tail: jnp.ndarray      # uint32 position implied by the tail section
    #                        (tail - pos = net indel: >0 deletion, <0 insertion)
    anchor: jnp.ndarray     # uint32 kv of the cluster's creation hit (the
    #                         vote-table slot position, vote->pos[i][j])
    votes: jnp.ndarray      # int32 number of distinct probing subreads
    strand: jnp.ndarray     # int32 0 = forward, 1 = reverse-complement
    cov_start: jnp.ndarray  # int32 smallest read offset voting in the cluster
    cov_end: jnp.ndarray    # int32 largest read offset + KMER
    probe_kv: jnp.ndarray   # uint32 [R, K, P] member kv per probe (the
    #                         indel_recorder analog, sorted-hashtable.c:1049:
    #                         kv steps along probes = cumulative indels;
    #                         SENTINEL where the probe didn't vote)
    saturated: jnp.ndarray  # bool [R] some probe's key run extended past the
    #                         H-entry gather window: vote counts may be low —
    #                         re-vote the read with a wider rescue pass
    apk: jnp.ndarray = None  # int32 [R, K] anchor arrival key
    #                          strand*P + probe-scan-index of the creation
    #                          hit (the within-row tie order above)


def applied_subreads(read_len: int, params: VoteParams) -> int:
    """The reference's per-length probe count (core.c:3116-3129): reads
    up to EXON_LONG_READ_LENGTH=160 spread `total_subreads` probes; longer
    reads probe every 6bp, capped at 63 probes."""
    L = int(read_len)
    gap = params.index_gap
    if L < KMER:
        return 1
    cr = (L - 15 - gap) << 16
    if L <= 160:
        S = params.total_subreads
        step = max(cr // max(S - 1, 1) if S > 1 else cr, gap << 16)
    else:
        step = 6 << 16
        if cr // step > 62:
            step = cr // 62
    return 1 + cr // max(step, 1)


def subread_offsets(read_len: jnp.ndarray, params: VoteParams,
                    n_sub: int) -> tuple[jnp.ndarray, np.ndarray]:
    """Probe start offsets per read: [R, n_sub*gap] int32, plus
    probe→subread id (numpy [P]).

    Mirrors the spacing rule in do_voting (core.c:3115-3184): 16.16
    fixed-point step = max(index_gap, (L-15-index_gap)/(S-1)) for reads
    <= 160, 6bp (capped at 63 probes) beyond; with a gapped index every
    nominal offset is probed at all `index_gap` phases.  n_sub (static)
    bounds the probe count — applied_subreads of the longest read."""
    S = params.total_subreads
    gap = params.index_gap
    L = read_len.astype(jnp.int32)[:, None]  # [R, 1]
    # 16.16 fixed point is int32-safe here: (1210-15-3)<<16 < 2^31 and
    # k*step <= 62 * ((L<<16)/62) < 2^31
    cr = (L - 15 - gap) << 16
    short_fx = jnp.maximum(
        gap << 16,
        jnp.where(S > 1, cr // jnp.maximum(S - 1, 1), jnp.maximum(cr, 1)),
    )
    long_fx = jnp.where(cr // (6 << 16) > 62, cr // 62, 6 << 16)
    step_fx = jnp.where(L <= 160, short_fx, long_fx)
    s_idx = np.arange(n_sub, dtype=np.int32)[None, :]  # [1, n_sub]
    base = (s_idx * step_fx) >> 16  # [R, n_sub]
    if gap == 1:
        offsets = base
        sub_id = np.arange(n_sub, dtype=np.int32)
    else:
        # the reference snaps the nominal offset DOWN to a gap multiple
        # before adding the phase (core.c:3169-3171:
        # subread_offset -= subread_offset % GENE_SLIDING_STEP - xk1), so
        # gapped probes sit on the index's stored-position grid exactly
        phases = np.arange(gap, dtype=np.int32)
        base = base - base % gap
        offsets = (base[:, :, None] + phases[None, None, :]).reshape(
            base.shape[0], n_sub * gap
        )
        sub_id = np.repeat(np.arange(n_sub, dtype=np.int32), gap)
    offsets = jnp.minimum(offsets, jnp.maximum(L - KMER, 0))
    # sub_id stays a numpy array: a jax.Array constant would be embedded in
    # the lowered module via a device->host fetch.
    return offsets, sub_id


def static_offsets(read_len: int, params: VoteParams) -> np.ndarray:
    """numpy mirror of subread_offsets for a single static read length:
    int32 [applied*gap].  Used when every read in the batch shares one
    length — the per-probe key extraction then becomes static column
    slices (no gather)."""
    S = params.total_subreads
    gap = params.index_gap
    L = int(read_len)
    cr = (L - 15 - gap) << 16
    if L <= 160:
        step_fx = max(gap << 16, cr // max(S - 1, 1) if S > 1 else cr)
    else:
        step_fx = 6 << 16
        if cr // step_fx > 62:
            step_fx = cr // 62
    n = 1 + cr // max(step_fx, 1)
    base = (np.arange(n, dtype=np.int64) * step_fx) >> 16
    if gap == 1:
        offsets = base
    else:
        # nominal offset snapped down to the gap grid + phase (core.c:3169)
        base = base - base % gap
        offsets = (base[:, None] + np.arange(gap)[None, :]).reshape(-1)
    return np.minimum(offsets, max(L - KMER, 0)).astype(np.int32)


def probe_keys_static(
    codes: jnp.ndarray, ambig: jnp.ndarray, offsets: np.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Probe 16-mer keys at STATIC offsets: ([R, P] uint32 keys,
    [R, P] bool window-ambiguity).  P static slices of width KMER packed
    by shifts — all elementwise, no gather, and only P*KMER columns
    touched instead of rolling keys over the whole read."""
    R, L = codes.shape
    c32 = codes.astype(jnp.uint32)
    cols_k = []
    cols_a = []
    for o in offsets.tolist():
        acc = jnp.zeros((R,), jnp.uint32)
        wa = jnp.zeros((R,), bool)
        for j in range(KMER):
            acc = acc | (c32[:, o + j] << np.uint32(2 * (KMER - 1 - j)))
            wa = wa | ambig[:, o + j]
        cols_k.append(acc)
        cols_a.append(wa)
    return jnp.stack(cols_k, axis=1), jnp.stack(cols_a, axis=1)


def rolling_keys(codes: jnp.ndarray, ambig: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-offset 16-mer keys and window-ambiguity over whole reads.

    keymat[:, i] = big-endian 2-bit key of codes[:, i:i+16] (garbage within
    15 of the right edge — callers mask by read length); built from 16
    static column shifts, all elementwise — no gather.  wamb[:, i] = any
    ambiguous base in the window.
    """
    R, L = codes.shape
    acc = jnp.zeros((R, L), jnp.uint32)
    wamb = jnp.zeros((R, L), bool)
    c32 = codes.astype(jnp.uint32)
    for j in range(KMER):
        sh = np.uint32(2 * (KMER - 1 - j))
        cj = jnp.pad(c32[:, j:], ((0, 0), (0, j)))
        aj = jnp.pad(ambig[:, j:], ((0, 0), (0, j)))
        acc = acc | (cj << sh)
        wamb = wamb | aj
    return acc, wamb


def revcomp_keys(keys: jnp.ndarray) -> jnp.ndarray:
    """Reverse-complement of packed 16-mer keys, elementwise.

    Complement: codes are A=0,G=1,C=2,T=3 with 3-x the complement, so a
    bitwise NOT complements every 2-bit group; then reverse the sixteen
    2-bit groups with the classic swap ladder."""
    x = ~keys
    m2, m4, m8 = np.uint32(0x33333333), np.uint32(0x0F0F0F0F), np.uint32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def extract_probe_keys(
    codes: jnp.ndarray,     # uint8/int32 [R, L]
    ambig: jnp.ndarray,     # bool [R, L]
    read_len: jnp.ndarray,  # int32 [R]
    offsets: jnp.ndarray,   # int32 [R, P]
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Big-endian-packed 16-mer keys at each probe offset: [R, P] uint32,
    plus validity (inside read, no ambiguous base): [R, P] bool."""
    keymat, wamb = rolling_keys(codes, ambig)
    off_c = jnp.minimum(offsets, codes.shape[1] - 1)
    keys = jnp.take_along_axis(keymat, off_c, axis=1)
    wa = jnp.take_along_axis(wamb, off_c, axis=1)
    valid = (
        (offsets + KMER <= read_len[:, None])
        & ~wa
        & (read_len[:, None] >= KMER)
    )
    return keys, valid


GROUP = 16                # index entries per combined row
COMB_W = GROUP + GROUP // 2   # row layout: 16 positions + 8 packed check16 words


def gather_hits(
    probe_keys: jnp.ndarray,    # uint32 [R, P] CANONICAL keys
    probe_valid: jnp.ndarray,   # bool [R, P]
    bucket_start: jnp.ndarray,  # int32 [B+1]
    comb_rows: jnp.ndarray,     # uint32 [G, 24]: 16 positions + 8 check words
    bucket_bits: int,
    params: VoteParams,
    sub_base: jnp.ndarray | None = None,  # int32 [B] (-1 = small bucket)
    sub_lo: jnp.ndarray | None = None,    # int32 sub-bucket directory
    sub_bits: int = 0,
    search_steps: int = 0,
    probe_orient: jnp.ndarray | None = None,  # bool [R, P]: required stored
    #                                           orientation of matching hits
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(Key, orientation)-run window fetch via ROW gathers with exact
    check16 verification.

    Replaces the reference's in-bucket binary search
    (sorted-hashtable.c:960-981): with B = 2**bucket_bits high-bit buckets
    the average bucket holds about one entry, so the H-wide window
    [lo, lo+H) covers the probe's whole run with NO search for any bucket
    of <= BIG_BUCKET entries.  Repeat-dense buckets (tandem repeats
    concentrate many high-occurrence keys sharing their prefix) can hold
    hundreds of entries, where a head-of-bucket window would miss runs
    entirely — for those the build-time SUB-BUCKET DIRECTORY
    (index.build.build_sub_directory) maps the probe's next `sub_bits`
    check bits straight to its run's start: two extra scalar gathers,
    replacing a log2(max_bucket)-trip scalar-gather search loop that
    measured ~11ms per 16K-read dispatch on chr901.  The builder
    guarantees the jump lands exactly on the run start (search_steps=0);
    a residual fixed-trip lower_bound remains only for the pathological
    directory-size-capped case.

    The check16 is ((key remainder) << 1) | stored_orientation and entries
    sort by (key, orientation, position), so the probe's full-check
    equality match returns ONLY entries of its required orientation
    (probe_orient) — no aliasing, no wrong-strand entries in the window,
    and the truncation bound is the PER-ORIENTATION run length.

    Index entries are stored in COMBINED rows of GROUP=16: row g =
    [pos_{16g..16g+15}, check16s packed into 8 words].  Gathering 2-D
    ROWS lets a probe fetch its whole window — positions AND checks — with
    ceil(H/16)+1 row gathers instead of H scalar gathers (fewer, wider
    rows; the layout was tuned on the accelerator the code was first
    written for and is not re-measured on the GPU yet).  The window is
    then phase-aligned to lo&15 with a static 4-step shift ladder
    computed on the FLAT [R, P*NW] layout; the ladder's shifts never
    cross a probe's NW-wide block within the slots that are read
    afterwards (slot j reads original index j+phase <= (H-1)+15 < NW).

    Returns (hit_pos uint32, hit_valid bool) each FLAT [R, C] with
    C = P*H (candidate-major: probe p's hits at columns p*H..p*H+H-1),
    plus truncated bool [R, P]: the run extends beyond the H-entry window
    (callers route such reads to a wider rescue pass).
    """
    R, P = probe_keys.shape
    G = comb_rows.shape[0]
    H = params.max_hits
    # rows covering H entries at any phase: slot j reads original index
    # j + (lo & 15), so the window must hold H-1+15 entries past its start
    NR = (H + GROUP - 1) // GROUP + 1
    NW = NR * GROUP            # fetched window width (48 for H=32)
    shift = np.uint32(32 - bucket_bits)
    bucket = (probe_keys >> shift).astype(jnp.int32)
    lo = bucket_start[bucket]
    hi = bucket_start[bucket + 1]
    # full in-bucket check: (key remainder << 1) | required orientation
    rem = probe_keys & np.uint32((1 << (32 - bucket_bits)) - 1)
    if probe_orient is None:
        probe_orient = jnp.zeros(probe_keys.shape, bool)
    qcheck_p = (rem << np.uint32(1)) | probe_orient.astype(jnp.uint32)

    if sub_bits and sub_base is not None:
        # big-bucket jump: directory slot = top sub_bits of the check
        sb = sub_base[bucket]
        sub = (qcheck_p >> np.uint32(33 - bucket_bits - sub_bits)).astype(
            jnp.int32
        )
        lo2 = sub_lo[jnp.maximum(sb, 0) + sub]
        lo = jnp.where(sb >= 0, lo2, lo)

    if search_steps:
        # residual branchless lower_bound over [lo, lo + 2**steps) — only
        # when the directory was memory-capped (never for built indexes).
        # Scalar check fetches address the packed words inside comb_rows
        # directly (entry i = word 16 + (i&15)//2 of row i>>4).
        flat = comb_rows.reshape(-1)

        def bs_body(_, carry):
            cur, length = carry
            half = length >> 1
            mid = cur + half
            w = flat[(mid >> 4) * COMB_W + GROUP + ((mid & 15) >> 1)]
            c = (w >> ((mid.astype(jnp.uint32) & 1) << 4)) & np.uint32(0xFFFF)
            # length <= 0 means cur already IS the lower bound: freeze
            # (otherwise a stray check at cur — e.g. the next bucket's
            # first entry — could push cur past the run start)
            right = (c < qcheck_p) & (length > 0)
            return (
                jnp.where(right, mid + 1, cur),
                jnp.where(right, length - half - 1, jnp.minimum(half, length)),
            )

        len0 = jnp.minimum(hi - lo, np.int32(1 << search_steps))
        lo, _ = jax.lax.fori_loop(0, search_steps, bs_body, (lo, len0))

    r0 = lo >> np.int32(4)
    ridx = jnp.minimum(
        r0[:, :, None] + np.arange(NR, dtype=np.int32), G - 1
    )                                             # [R, P, NR]
    rows = comb_rows[ridx]                        # [R, P, NR, COMB_W]

    pos_w = rows[:, :, :, :GROUP].reshape(R, P * NW)
    chk_words = rows[:, :, :, GROUP:].reshape(R, P, NR * 8)
    half_sh = (np.uint32(16) * np.arange(2, dtype=np.uint32))[None, None, None, :]
    chk_b = ((chk_words[:, :, :, None] >> half_sh) & np.uint32(0xFFFF)).reshape(
        R, P * NW
    )

    # phase-align so slot j holds entry lo + j (static shift ladder on the
    # flat layout; per-element phase = its probe's lo & 15)
    ph = jnp.repeat(lo & 15, NW, axis=1)          # [R, P*NW]
    for b in (8, 4, 2, 1):
        on = (ph & b) != 0
        sh = lambda a: jnp.pad(a[:, b:], ((0, 0), (0, b)))
        pos_w = jnp.where(on, sh(pos_w), pos_w)
        chk_b = jnp.where(on, sh(chk_b), chk_b)
    # take the first H aligned slots of each probe's NW block -> [R, C]
    hit_pos = pos_w.reshape(R, P, NW)[:, :, :H].reshape(R, P * H)
    checks = chk_b.reshape(R, P, NW)[:, :, :H].reshape(R, P * H)

    lo_rep = jnp.repeat(lo, H, axis=1)            # [R, C]
    hi_rep = jnp.repeat(hi, H, axis=1)
    offs = np.tile(np.arange(H, dtype=np.int32), P)[None, :]
    idx = lo_rep + offs
    qcheck = jnp.repeat(qcheck_p, H, axis=1)
    hit_valid = (
        (idx < hi_rep)
        & (checks == qcheck)
        & jnp.repeat(probe_valid, H, axis=1)
    )
    # run extends past the window iff its last slot still matched
    truncated = hit_valid.reshape(R, P, H)[:, :, H - 1]
    return hit_pos, hit_valid, truncated


def _vote_merged(
    kv: jnp.ndarray,        # uint32 [R, C] candidate positions (SENTINEL = invalid)
    payload: jnp.ndarray,   # uint32 [R, C]: off | strand<<12 | sub_id<<13 | pk<<19
    params: VoteParams,
    n_sub: int | None = None,
) -> tuple[jnp.ndarray, ...]:
    """Sort ALL candidates (both strands in ONE stream) by kv and compute
    the reference's ANCHORED cluster votes (sorted-hashtable.c:1007-1060):
    a cluster is created at its first-arriving hit (probe scan order), all
    same-strand hits within ±tol of that anchor join it, and its vote is
    the number of distinct subreads among the members.

    On the sorted stream this becomes, per element e:
      - membership: |kv_w - kv_e| <= tol, same strand
      - votes(e)  : popcount of the distinct-subread mask over the members
        ASSIGNED to e's slot (first-match assignment, see below)
      - anchor(e) : no same-strand member has a smaller (probe, kv) pair —
        i.e. e is the hit the sequential reference scan would have created
        the cluster at.  Non-anchors get votes=0 so top-K never picks the
        same cluster twice or from a shifted window (which overcounts).

    Each index hit belongs to exactly one strand (the orientation-split
    index returns only the probe's required orientation), so merging
    halves the sort + window work vs per-strand streams.  The per-slot
    distinct-subread mask keys on ((kv << 1) | strand) — positions are
    < 2^31 — and holds one bit per subread: one uint32 word for <= 32
    probes per scan, two words for the >160bp ladder (up to 63 probes,
    core.c:3118-3129).  Coverage min/max are NOT accumulated here — they
    are computed for just the K selected anchors in vote_batch.

    Returns sorted (kv, votes, strand, pk) each [R, C].
    """
    R, C = kv.shape
    S = params.total_subreads if n_sub is None else n_sub
    kv_s, pay_s = jax.lax.sort((kv, payload), dimension=-1, num_keys=1)
    CC = params.compact
    overflow = None
    if CC and CC < C:
        # candidates sort ascending with SENTINEL padding at the end, so
        # the first CC sorted entries hold EVERY valid candidate unless
        # entry CC itself is still valid — those (rare, repeat-heavy)
        # reads overflow to the wider rescue pass via `saturated`
        overflow = kv_s[:, CC] != SENTINEL
        kv_s = kv_s[:, :CC]
        pay_s = pay_s[:, :CC]
        C = CC
    off_s = (pay_s & np.uint32(0xFFF)).astype(jnp.int32)
    strand_su = (pay_s >> np.uint32(12)) & np.uint32(1)
    strand_s = strand_su.astype(jnp.int32)
    sub_s = (pay_s >> np.uint32(13)) & np.uint32(0x3F)
    dual = S > 32
    if dual:
        mask_s = jnp.where(
            sub_s < 32, jnp.uint32(1) << sub_s, np.uint32(0)
        )
        mask_hi_s = jnp.where(
            sub_s >= 32, jnp.uint32(1) << (sub_s - np.uint32(32)),
            np.uint32(0),
        )
    else:
        mask_s = jnp.uint32(1) << sub_s
        mask_hi_s = None
    # anchor-ordering key: probe scan index in the oriented read's own scan
    # (reverse-strand probes scan the RC read left-to-right), lower = earlier.
    # Packed with the strand in bit 8 (spk = pk | strand<<8): XORing a
    # window element's spk with the center's strand<<8 yields pk for
    # same-strand members and pk+256 for the other strand, so one int16
    # min replaces the separate strand compare — the window loop then
    # slices 2 arrays per step instead of 4.
    pk_s = ((pay_s >> np.uint32(19)) & np.uint32(0xFF)).astype(jnp.int16)
    spk_s = pk_s | (strand_su.astype(jnp.int16) << np.int16(8))

    W = min(params.window, C)
    tol = np.uint32(params.indel_tolerance)
    tol2 = np.uint32(2 * params.indel_tolerance)
    BIGPK = jnp.int16(0x7FFF)
    sflip = strand_su.astype(jnp.int16) << np.int16(8)
    pad2 = lambda a, v: jnp.pad(a, ((0, 0), (W, W)), constant_values=v)
    pad_kv = pad2(kv_s, np.uint32(0xFFFFFFFF))
    pad_mask = pad2(mask_s, np.uint32(0))
    pad_mask_hi = pad2(mask_hi_s, np.uint32(0)) if dual else None
    pad_spk = pad2(spk_s, 0x3FFF)

    # span-overflow guard: if any W+1 consecutive sorted entries sit within
    # the cluster tolerance (kv[i+W] - kv[i] <= tol with kv[i] valid), some
    # center's ±W slot window cannot reach every member within ±tol and
    # votes would be silently undercounted.  Such reads (dense tandem
    # repeats) are flagged into the saturation-rescue chain, whose passes
    # escalate the window until this guard clears.
    kvW = jax.lax.dynamic_slice_in_dim(pad_kv, 2 * W, C, axis=1)
    span_over = jnp.any((kvW - kv_s <= tol) & (kv_s != SENTINEL), axis=1)
    overflow = span_over if overflow is None else (overflow | span_over)

    # in-window test: kd - kv_s in [-tol, tol] <=> kd - kv_s + tol <= 2*tol
    # unsigned (one add + one compare).  No SENTINEL guard is needed:
    # SENTINEL neighbours sit 2^32-1 - kv away from any genuine candidate
    # (positions are >= the contig padding), and SENTINEL *centers* match
    # only other sentinels — their votes are masked at the end anyway.
    def cand_at(d):
        kd = jax.lax.dynamic_slice_in_dim(pad_kv, d, C, axis=1)
        in_w = (kd - kv_s + tol) <= tol2
        spkd = jax.lax.dynamic_slice_in_dim(pad_spk, d, C, axis=1)
        return jnp.where(in_w, spkd ^ sflip, BIGPK)

    # pass A — anchor (slot creation) detection.  Two loops so the
    # left-half-only leftpk min costs nothing on the right half.
    def body_left(d, carry):
        minpk, leftpk = carry
        cand = cand_at(d)
        return jnp.minimum(minpk, cand), jnp.minimum(leftpk, cand)

    def body_right(d, minpk):
        return jnp.minimum(minpk, cand_at(d))

    init = (
        jnp.full((R, C), 0x7FFF, jnp.int16),
        jnp.full((R, C), 0x7FFF, jnp.int16),
    )
    minpk, leftpk = jax.lax.fori_loop(0, W, body_left, init)
    minpk = jax.lax.fori_loop(W, 2 * W + 1, body_right, minpk)

    # e is its cluster's creation hit iff nothing in-window scans earlier:
    # no same-strand member with smaller probe anywhere (minpk includes
    # self; other-strand members carry +256 via the spk XOR), and no LEFT
    # member (smaller kv) sharing its probe index
    is_anchor = (minpk == pk_s) & (leftpk > pk_s) & (kv_s != SENTINEL)

    # --- first-match slot assignment (gehash_go_X, sorted-hashtable.c:
    # 1007-1071): each hit votes for ONE slot — the first matching one in
    # the iix row-scan order over rows (kv/5), (kv/5)+1, (kv/5)-1, ...
    # Same-strand slots are always > tol apart, so at most TWO (the
    # nearest anchor left and right in kv) are reachable; the winner is
    # the one whose 5-wide band is probed first: band offset b =
    # floor(a/5) - floor(kv/5), rank 0 for b=0, 2b-1 for b>0, -2b for
    # b<0 (iix sequence 0, +5, -5, +10, -10 ...).
    own_kv = jnp.where(is_anchor, kv_s, np.uint32(0))
    aL0 = jax.lax.cummax(jnp.where(strand_s == 0, own_kv, 0), axis=1)
    aL1 = jax.lax.cummax(jnp.where(strand_s == 1, own_kv, 0), axis=1)
    aL = jnp.where(strand_s == 1, aL1, aL0)
    own_kv_r = jnp.where(is_anchor, kv_s, SENTINEL)
    rev = lambda a: jnp.flip(a, axis=1)
    aR0 = rev(jax.lax.cummin(rev(jnp.where(strand_s == 0, own_kv_r, SENTINEL)), axis=1))
    aR1 = rev(jax.lax.cummin(rev(jnp.where(strand_s == 1, own_kv_r, SENTINEL)), axis=1))
    aR = jnp.where(strand_s == 1, aR1, aR0)
    okL = (aL > 0) & (kv_s - aL <= tol)
    okR = (aR != SENTINEL) & (aR - kv_s <= tol)
    band = lambda x: (x // np.uint32(5)).astype(jnp.int32)
    bL = band(aL) - band(kv_s)          # <= 0
    bR = band(aR) - band(kv_s)          # >= 0
    rkL = jnp.where(bL == 0, 0, -2 * bL)
    rkR = jnp.where(bR == 0, 0, 2 * bR - 1)
    assigned = jnp.where(
        okL & (~okR | (rkL <= rkR)), aL, jnp.where(okR, aR, SENTINEL)
    )
    assigned = jnp.where(kv_s == SENTINEL, SENTINEL - np.uint32(1), assigned)

    # pass B — per-slot distinct-subread accumulation over assigned
    # members.  The slot key carries the strand in its LSB (positions are
    # < 2^31) so opposite-strand slots at one kv never mix.
    asg_key = jnp.where(
        kv_s == SENTINEL,
        np.uint32(0xFFFFFFFD),
        (assigned << np.uint32(1)) | strand_su,
    )
    own_key = (kv_s << np.uint32(1)) | strand_su
    pad_asg = pad2(asg_key, np.uint32(0xFFFFFFFE))

    if dual:
        def body_acc(d, carry):
            acc, acc_hi = carry
            ad = jax.lax.dynamic_slice_in_dim(pad_asg, d, C, axis=1)
            hit = ad == own_key
            md = jax.lax.dynamic_slice_in_dim(pad_mask, d, C, axis=1)
            mh = jax.lax.dynamic_slice_in_dim(pad_mask_hi, d, C, axis=1)
            return (acc | jnp.where(hit, md, 0),
                    acc_hi | jnp.where(hit, mh, 0))

        acc_mask, acc_hi = jax.lax.fori_loop(
            0, 2 * W + 1, body_acc,
            (jnp.zeros_like(mask_s), jnp.zeros_like(mask_s)),
        )
        votes = (
            jax.lax.population_count(acc_mask)
            + jax.lax.population_count(acc_hi)
        ).astype(jnp.int32)
    else:
        def body_acc(d, acc):
            ad = jax.lax.dynamic_slice_in_dim(pad_asg, d, C, axis=1)
            md = jax.lax.dynamic_slice_in_dim(pad_mask, d, C, axis=1)
            return acc | jnp.where(ad == own_key, md, 0)

        acc_mask = jax.lax.fori_loop(
            0, 2 * W + 1, body_acc, jnp.zeros_like(mask_s)
        )
        votes = jax.lax.population_count(acc_mask).astype(jnp.int32)
    votes = jnp.where(is_anchor, votes, 0)
    return kv_s, votes, strand_s, pk_s.astype(jnp.int32), acc_mask, overflow


@functools.partial(
    jax.jit,
    static_argnames=("bucket_bits", "params", "static_len", "sub_bits",
                     "search_steps"),
)
def vote_batch(
    codes: jnp.ndarray,        # uint8 [R, L]
    ambig: jnp.ndarray,        # bool [R, L]
    read_len: jnp.ndarray,     # int32 [R]
    bucket_start: jnp.ndarray,
    comb_rows: jnp.ndarray,    # uint32 [G, 24] combined position/check rows
    bucket_bits: int,
    params: VoteParams,
    static_len: int | None = None,
    sub_base: jnp.ndarray | None = None,
    sub_lo: jnp.ndarray | None = None,
    sub_bits: int = 0,
    search_steps: int = 0,
) -> VoteResult:
    """Full vote step for a read batch over both strands.

    static_len: when every real read in the batch shares one length, the
    probe offsets are compile-time constants — key extraction becomes P
    static column slices (no rolling keys over all L columns, no
    take_along_axis gathers).  Reads shorter than static_len (batch
    padding) are masked out via read_len.
    """
    R, L = codes.shape
    H = params.max_hits
    S = params.total_subreads
    gap = max(params.index_gap, 1)
    # probes per strand scan: the reference's per-length applied_subreads
    # (>160bp reads probe every 6bp up to 63 probes, core.c:3116-3129)
    n_sub = applied_subreads(
        static_len if static_len is not None and static_len >= KMER else L,
        params,
    )
    P0 = n_sub * gap

    # TWO probe grids, one per strand scan, exactly as the reference runs
    # them (do_voting, core.c:3110-3186: all forward-read probes, then all
    # probes of the REVERSED read at the same offset grid).  The reverse
    # scan's probe at rev-offset o reads the revcomp of the forward read's
    # window at L-16-o — and because the grid is not mirror-symmetric,
    # those are DIFFERENT 16-mers than the forward probes (an earlier
    # canonical-probe design reused the forward grid for both strands and
    # skewed reverse-strand vote counts by ±1).  Each probe accepts only
    # hits of its own orientation; everything per-probe (own-scan offset,
    # strand, subread id, arrival index) is a static per-column constant.
    if static_len is not None and static_len >= KMER:
        offs_f = static_offsets(static_len, params)            # [P0] numpy
        extract_np = np.concatenate(
            [offs_f, (static_len - KMER - offs_f)]
        )                                                       # [2P0]
        keys_raw, wamb_p = probe_keys_static(codes, ambig, extract_np)
        rck = revcomp_keys(keys_raw)
        keys = jnp.minimum(keys_raw, rck)
        # flip_req: stored orientation that makes the hit match THIS probe
        # (probe kmer = raw for forward probes, revcomp(raw) for reverse)
        nprobe = extract_np.shape[0]
        is_rev_p = np.arange(nprobe) >= P0                     # [2P0] numpy
        flip_req = jnp.where(
            jnp.asarray(is_rev_p)[None, :], keys != rck, keys != keys_raw
        )
        valid = ~wamb_p & (read_len[:, None] >= np.int32(static_len))
        ownoff_np = np.concatenate([offs_f, offs_f])           # [2P0]
        own_b = ownoff_np[None, :]
    else:
        offsets_f, sub_id0 = subread_offsets(read_len, params, n_sub)
        extract = jnp.concatenate(
            [offsets_f,
             jnp.maximum(read_len[:, None] - KMER - offsets_f, 0)],
            axis=1,
        )                                                       # [R, 2P0]
        keymat, wamb = rolling_keys(codes, ambig)
        rcmat = revcomp_keys(keymat)
        canonmat = jnp.minimum(keymat, rcmat)
        flipf_mat = canonmat != keymat
        flipr_mat = canonmat != rcmat
        in_read = (
            (extract + KMER <= read_len[:, None])
            & (read_len[:, None] >= KMER)
        )
        off_c = jnp.clip(extract, 0, L - 1)
        keys = jnp.take_along_axis(canonmat, off_c, axis=1)
        nprobe = 2 * P0
        is_rev_p = np.arange(nprobe) >= P0
        flip_req = jnp.where(
            jnp.asarray(is_rev_p)[None, :],
            jnp.take_along_axis(flipr_mat, off_c, axis=1),
            jnp.take_along_axis(flipf_mat, off_c, axis=1),
        )
        valid = in_read & ~jnp.take_along_axis(wamb, off_c, axis=1)
        own_b = jnp.concatenate([offsets_f, offsets_f], axis=1)  # [R, 2P0]

    sn_np = np.tile(
        np.repeat(np.arange(n_sub, dtype=np.int32), gap) if gap > 1
        else np.arange(n_sub, dtype=np.int32), 2
    )                                                           # [2P0]
    P = nprobe
    C = P * H
    hit_pos, hit_valid, trunc = gather_hits(
        keys, valid, bucket_start, comb_rows, bucket_bits, params,
        sub_base, sub_lo, sub_bits, search_steps,
        probe_orient=flip_req,
    )                                                          # each [R, C]
    # mixed-width rescue (wide_slots > 0): re-gather ONLY the saturated
    # probes at wide_hits width.  A saturated read typically has 1-8
    # truncated probes out of 2*P0 (chr901 16K batch: median 3), so
    # re-voting the whole read at the wide width — the old two-tier
    # rescue — moved ~1.6x the main pass's gather volume to fix ~15% of
    # the probes.  Here the wide block adds E*wide_hits columns for the
    # E compacted saturated probes; duplicate (kv, subread) hits from
    # the overlapping narrow window collapse in the distinct-subread
    # vote mask, so the union is exact.
    E = params.wide_slots
    trunc_w = None
    if E:
        HW = params.wide_hits
        # first E truncated probe columns per read (stable over probe idx)
        sel = jnp.argsort(~trunc, axis=1, stable=True)[:, :E]  # [R, E]
        take_p = lambda a: jnp.take_along_axis(a, sel, axis=1)
        sel_trunc = take_p(trunc)
        keys_w = take_p(keys)
        flip_w = take_p(flip_req)
        params_w = params._replace(max_hits=HW)
        hitp_w, hitv_w, trunc_ww = gather_hits(
            keys_w, sel_trunc, bucket_start, comb_rows, bucket_bits,
            params_w, sub_base, sub_lo, sub_bits, search_steps,
            probe_orient=flip_w,
        )                                                      # [R, E*HW]
        # residual saturation: a wide window still truncated, or more
        # truncated probes than wide slots
        trunc_w = jnp.any(trunc_ww, axis=1) | (
            jnp.sum(trunc.astype(jnp.int32), axis=1) > E
        )
        # per-column metadata for the wide block (dynamic: per-read probes)
        if isinstance(own_b, np.ndarray) and own_b.shape[0] == 1:
            own_full = jnp.broadcast_to(
                jnp.asarray(ownoff_np.astype(np.int32))[None, :], (R, nprobe)
            )
        else:
            own_full = own_b.astype(jnp.int32)
        off_w = jnp.repeat(take_p(own_full), HW, axis=1)       # [R, E*HW]
        strand_full = jnp.broadcast_to(
            jnp.asarray(is_rev_p.astype(np.uint32))[None, :], (R, nprobe)
        )
        strand_w = jnp.repeat(take_p(strand_full), HW, axis=1)
        sub_full = jnp.broadcast_to(
            jnp.asarray(
                np.tile(
                    np.repeat(np.arange(n_sub, dtype=np.uint32), gap)
                    if gap > 1 else np.arange(n_sub, dtype=np.uint32), 2
                )
            )[None, :], (R, nprobe)
        )
        sub_w = jnp.repeat(take_p(sub_full), HW, axis=1)
        pk_full = jnp.broadcast_to(
            jnp.asarray(
                np.concatenate([np.arange(P0), np.arange(P0)])
                .astype(np.uint32)
            )[None, :], (R, nprobe)
        )
        pk_w = jnp.repeat(take_p(pk_full), HW, axis=1)
        kv_w = jnp.where(
            hitv_w, hitp_w - off_w.astype(jnp.uint32), SENTINEL
        )
        payload_w = (
            off_w.astype(jnp.uint32)
            | (strand_w << np.uint32(12))
            | (sub_w << np.uint32(13))
            | (pk_w << np.uint32(19))
        )
    # expand per-probe quantities to per-candidate columns (repeat H);
    # everything elementwise below runs on the FLAT [R, C] layout so the
    # VPU's 128-lane tiles are full
    if isinstance(own_b, np.ndarray) and own_b.shape[0] == 1:
        off_r = np.repeat(own_b[0], H)[None, :]                # static numpy
    else:
        off_r = jnp.repeat(own_b, H, axis=1)
    strand3_np = np.repeat(is_rev_p.astype(np.uint32), H)[None, :]
    strand3 = jnp.broadcast_to(jnp.asarray(strand3_np), (R, C))
    # own-scan subread id only: _vote_merged shifts the mask bit by
    # S*strand itself
    subid_r = np.repeat(sn_np.astype(np.uint32), H)[None, :]
    off3 = (
        jnp.broadcast_to(jnp.asarray(off_r), (R, C))
        if isinstance(off_r, np.ndarray) else off_r
    ).astype(jnp.int32)
    kv3 = jnp.where(
        hit_valid, hit_pos - off3.astype(jnp.uint32), SENTINEL
    )                                                          # [R, C]
    # probe scan index within the candidate's own strand scan
    pk3_np = np.repeat(
        np.concatenate([np.arange(P0), np.arange(P0)]).astype(np.uint32), H
    )[None, :]
    payload = (
        off3.astype(jnp.uint32)
        | (strand3 << np.uint32(12))
        | (subid_r << np.uint32(13))
        | (jnp.asarray(pk3_np) << np.uint32(19))
    )
    C0 = C
    if E:
        kv3 = jnp.concatenate([kv3, kv_w], axis=1)
        payload = jnp.concatenate([payload, payload_w], axis=1)
        strand3 = jnp.concatenate([strand3, strand_w], axis=1)
        off3 = jnp.concatenate([off3, off_w.astype(jnp.int32)], axis=1)
        C = kv3.shape[1]
    kv_s, votes, strand_s, pk_s, _, overflow = _vote_merged(
        kv3, payload, params, n_sub
    )
    Cs = kv_s.shape[1]            # compacted sorted-stream width

    # --- top-K selection (both strands live in the one stream) ------------
    # Reference simple-list order (core-junction.c:2262-2310): vote count
    # level descending, then vote-table row (kv/5)%30 ascending, then slot
    # creation order (arrival of the cluster's first hit in the
    # strand-major scan: strand*P + probe index), then kv ascending (one
    # probe's hits arrive position-sorted).  Packed into one uint32 minor
    # key; votes stay the major key so level grouping is exact.
    K = params.top_k
    tol = np.uint32(params.indel_tolerance)
    row30 = ((kv_s // np.uint32(5)) % np.uint32(30)).astype(jnp.uint32)
    arrival = (
        strand_s.astype(jnp.uint32) * np.uint32(P0) + pk_s.astype(jnp.uint32)
    )
    minor = (row30 << np.uint32(9)) | jnp.minimum(arrival, np.uint32(511))
    sel_idx = jnp.zeros((R, K), jnp.int32)
    sel_votes = jnp.zeros((R, K), jnp.int32)
    BIGU = np.uint32(0xFFFFFFFF)
    col = jnp.broadcast_to(
        jnp.arange(Cs, dtype=jnp.int32)[None, :], (R, Cs)
    )
    work = votes
    for k in range(K):
        vmax = jnp.max(work, axis=-1, keepdims=True)            # [R, 1]
        lvl = (work == vmax) & (work > 0)
        m1 = jnp.min(jnp.where(lvl, minor, BIGU), axis=-1, keepdims=True)
        cand = lvl & (minor == m1)
        mkv = jnp.min(jnp.where(cand, kv_s, BIGU), axis=-1, keepdims=True)
        cand = cand & (kv_s == mkv)
        best = jnp.min(jnp.where(cand, col, 1 << 30), axis=-1)
        bestc = jnp.minimum(best, Cs - 1)
        sel_idx = sel_idx.at[:, k].set(bestc)
        # record the vote count AT PICK TIME: once every anchor is consumed
        # the pick degenerates, and its original votes must not leak back
        # in as a duplicate cluster
        sel_votes = sel_votes.at[:, k].set(
            jnp.where(vmax[:, 0] > 0, vmax[:, 0], 0)
        )
        bkv = jnp.take_along_axis(kv_s, bestc[:, None], axis=-1)
        bstrand = jnp.take_along_axis(strand_s, bestc[:, None], axis=-1)
        # suppress anchors of the same strand within ±tol of the chosen anchor
        diff = kv_s - bkv
        near = (diff <= tol) | (-diff <= tol)
        work = jnp.where(near & (strand_s == bstrand), 0, work)

    take = lambda arr: jnp.take_along_axis(arr, sel_idx, axis=-1)
    sel_kv = take(kv_s)
    sel_strand = take(strand_s)
    sel_apk = take(arrival.astype(jnp.int32))

    # cluster stats for just the K winners: ONE [R, K, C] membership pass
    # over the UNSORTED candidate stream (kv3/off3 — the sorted stream
    # would need a second, identical pass for the per-probe table).
    # head/tail = kv of the member with the smallest/largest read offset
    # (tail - head = net indel; the indel_recorder cumulative offset,
    # sorted-hashtable.c:1049-1060); offset ties resolve to the smallest
    # kv, matching the sorted-stream argmin/argmax this replaces.
    neg = np.uint32((1 << 32) - params.indel_tolerance)
    diff_p = kv3[:, None, :] - sel_kv[:, :, None]
    member = (
        ((diff_p <= tol) | (diff_p >= neg))
        & (kv3[:, None, :] != SENTINEL)
        & (strand3[:, None, :] == sel_strand[:, :, None].astype(jnp.uint32))
    )                                                          # [R, K, C]
    off3_m = off3[:, None, :]
    off_lo = jnp.where(member, off3_m, 1 << 30)
    off_hi = jnp.where(member, off3_m, -1)
    sel_covmin = jnp.min(off_lo, axis=-1)
    sel_covmax = jnp.max(off_hi, axis=-1)
    kv3_m = kv3[:, None, :]
    sel_head = jnp.min(
        jnp.where(member & (off3_m == sel_covmin[:, :, None]), kv3_m, SENTINEL),
        axis=-1,
    )
    sel_tail = jnp.min(
        jnp.where(member & (off3_m == sel_covmax[:, :, None]), kv3_m, SENTINEL),
        axis=-1,
    )

    # per-probe member kv (the indel_recorder analog): per-probe min over
    # each H-wide block of the same membership mask; wide-block columns
    # fold into their OWN probe's slot via the compacted probe indices
    masked_kv = jnp.where(member, kv3_m, SENTINEL)
    sel_pkv = jnp.min(
        masked_kv[:, :, :C0].reshape(R, K, P, H), axis=-1
    )
    if E:
        wide_min = jnp.min(
            masked_kv[:, :, C0:].reshape(R, K, E, params.wide_hits), axis=-1
        )                                                      # [R, K, E]
        oh = (
            sel[:, :, None]
            == jnp.arange(P, dtype=jnp.int32)[None, None, :]
        )                                                      # [R, E, P]
        contrib = jnp.min(
            jnp.where(
                oh[:, None, :, :], wide_min[:, :, :, None], SENTINEL
            ),
            axis=2,
        )                                                      # [R, K, P]
        sel_pkv = jnp.minimum(sel_pkv, contrib)

    empty = sel_votes <= 0
    return VoteResult(
        pos=jnp.where(empty, SENTINEL, sel_head),
        tail=jnp.where(empty, SENTINEL, sel_tail),
        anchor=jnp.where(empty, SENTINEL, sel_kv),
        votes=sel_votes,
        strand=sel_strand,
        cov_start=jnp.where(empty, 0, sel_covmin),
        cov_end=jnp.where(empty, 0, sel_covmax + KMER),
        probe_kv=jnp.where(empty[:, :, None], SENTINEL, sel_pkv),
        saturated=(
            (trunc_w if trunc_w is not None else jnp.any(trunc, axis=1))
            | (overflow if overflow is not None else False)
        ),
        apk=jnp.where(empty, 1 << 29, sel_apk),
    )


def merge_vote_results(a: VoteResult, b: VoteResult, params: VoteParams) -> VoteResult:
    """Merge two top-K vote tables into one (re-selected top-K).

    This is the accumulation step for a block-split index (the reference
    re-votes every read per index block into one shared vote table,
    core.c:3562-3613) and for position-sharded indexes across chips (each
    shard's partial VoteResult is allgathered and merged).  Anchors of the
    same strand within the indel tolerance are the same cluster seen from
    two blocks (boundary overlap): their votes are NOT summed — the max
    wins — because overlap regions would double-count probes.
    """
    K = params.top_k
    tol = np.uint32(params.indel_tolerance)
    cat = lambda x, y: jnp.concatenate([x, y], axis=1)
    pos = cat(a.pos, b.pos)
    tail = cat(a.tail, b.tail)
    anchor = cat(a.anchor, b.anchor)
    votes = cat(a.votes, b.votes)
    strand = cat(a.strand, b.strand)
    cov_s = cat(a.cov_start, b.cov_start)
    cov_e = cat(a.cov_end, b.cov_end)
    pkv = jnp.concatenate([a.probe_kv, b.probe_kv], axis=1)
    apk_a = a.apk if a.apk is not None else jnp.zeros_like(a.votes)
    apk_b = b.apk if b.apk is not None else jnp.zeros_like(b.votes)
    apk = cat(apk_a, apk_b)

    R = pos.shape[0]
    C2 = pos.shape[1]
    # the reference simple-list order (see vote_batch top-K): level desc,
    # vote-table row asc, arrival asc, kv asc
    row30 = ((anchor // np.uint32(5)) % np.uint32(30)).astype(jnp.uint32)
    minor = (row30 << np.uint32(9)) | jnp.minimum(
        apk.astype(jnp.uint32), np.uint32(511)
    )
    BIGU = np.uint32(0xFFFFFFFF)
    col = jnp.broadcast_to(jnp.arange(C2, dtype=jnp.int32)[None, :], (R, C2))
    sel_idx = jnp.zeros((R, K), jnp.int32)
    sel_votes = jnp.zeros((R, K), jnp.int32)
    work = votes
    for k in range(K):
        vmax = jnp.max(work, axis=-1, keepdims=True)
        lvl = (work == vmax) & (work > 0)
        m1 = jnp.min(jnp.where(lvl, minor, BIGU), axis=-1, keepdims=True)
        cand = lvl & (minor == m1)
        mkv = jnp.min(jnp.where(cand, anchor, BIGU), axis=-1, keepdims=True)
        cand = cand & (anchor == mkv)
        best = jnp.min(jnp.where(cand, col, 1 << 30), axis=-1)
        bestc = jnp.minimum(best, C2 - 1)
        sel_idx = sel_idx.at[:, k].set(bestc)
        sel_votes = sel_votes.at[:, k].set(
            jnp.where(vmax[:, 0] > 0, vmax[:, 0], 0)
        )
        bkv = jnp.take_along_axis(anchor, bestc[:, None], axis=-1)
        bstrand = jnp.take_along_axis(strand, bestc[:, None], axis=-1)
        diff = anchor - bkv
        near = (diff <= tol) | (-diff <= tol)
        work = jnp.where(near & (strand == bstrand), 0, work)
    take = lambda arr: jnp.take_along_axis(arr, sel_idx, axis=-1)
    empty = sel_votes <= 0
    return VoteResult(
        pos=jnp.where(empty, SENTINEL, take(pos)),
        tail=jnp.where(empty, SENTINEL, take(tail)),
        anchor=jnp.where(empty, SENTINEL, take(anchor)),
        votes=jnp.maximum(sel_votes, 0),
        strand=take(strand),
        cov_start=jnp.where(empty, 0, take(cov_s)),
        cov_end=jnp.where(empty, 0, take(cov_e)),
        probe_kv=jnp.take_along_axis(pkv, sel_idx[:, :, None], axis=1),
        saturated=a.saturated | b.saturated,
        apk=jnp.where(empty, 1 << 29, take(apk)),
    )
