"""Exon-exon junction detection (subjunc).

Reference: core-junction.c — major/minor vote-pair selection
(core_select_best_matching_halves :4900, process_voting_junction_PE_topK
:2199), split-point refinement with donor-site check (GT…AG fwd /
CT…AC rev, paired_chars_part_core :3472, donor_score :3675), junction
event edges (find_new_junctions :3865).

Device formulation: the read's top-K vote clusters already exist; a junction
candidate is (head cluster, tail cluster) on the same strand within the
max intron span.  The optimal split point is the same prefix/suffix
mismatch-cumsum scan as the indel placement (ops/extend.py) with the
genome offset D = tail_pos - head_pos, restricted to splits whose flanking
genome dinucleotides match a canonical donor/acceptor motif.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .extend import genome_base, genome_window

MAX_INTRON = 500_000  # core.h:218 default maximum intron length
# base codes (A=0,G=1,C=2,T=3): GT..AG fwd donor, CT..AC rev donor
G, T, A, C = 1, 3, 0, 2


def junction_split_scan(
    genome_u32: jnp.ndarray,
    oriented: jnp.ndarray,   # [R, L] read codes in genome orientation
    read_len: jnp.ndarray,   # [R]
    head_pos: jnp.ndarray,   # [R] uint32 alignment start of the head cluster
    gap: jnp.ndarray,        # [R] int32 D = tail_pos - head_pos (>0)
    valid: jnp.ndarray,      # [R] bool candidate pair exists
    guess_lo: jnp.ndarray | None = None,  # [R] head cov_end - 8
    guess_hi: jnp.ndarray | None = None,  # [R] tail cov_start + 8
):
    """Choose the junction split s (read coordinate) with the reference
    `donor_score` semantics (core-junction.c:3675-3830):

    - s confined to the coverage gap [guess_lo, guess_hi] (the minor scan
      passes cov_end(head)-8 .. cov_start(tail)+8, :1206-1210) and at
      least JUNCTION_CONFIRM_WINDOW=17 from either read end;
    - canonical donor/acceptor motif required (GT..AG fwd / CT..AC rev,
      check_donor_at_junctions default);
    - the 17-base confirm windows flanking s must match their OWN side
      with at most 1 total mismatch (left > W-2 matched and
      left+right >= 2W-1, :3753-3763);
    - each window must NOT match the OTHER side: >= 5 mismatches against
      the wrong genome side (:3768) — the gate that rejects repeat-copy
      pairs whose two "exons" are really one continuous copy;
    - best test_score = matched-own - matched-other wins; ties resolve
      center-out (the reference zig-zag scan from the gap middle).

    Returns dict(split, mism, clip_l, clip_r, donor_strand, ok);
    donor_strand 0 = GT..AG, 1 = CT..AC (the BED strand column).
    """
    R, L = oriented.shape
    W = 17  # JUNCTION_CONFIRM_WINDOW
    ar = np.arange(L, dtype=np.int32)[None, :]
    inside = ar < read_len[:, None]

    # head/tail genome base grids via the packed-word window fetch
    # (ceil(L/16)+1 gathered words per row instead of L scalar gathers)
    win_h = genome_window(genome_u32, head_pos, L + 2)
    win_t = genome_window(
        genome_u32,
        head_pos.astype(jnp.uint32) + gap.astype(jnp.uint32) - np.uint32(2),
        L + 2,
    )
    mm_h = (win_h[:, :L] != oriented.astype(jnp.uint32)) & inside
    prefix = jnp.cumsum(
        jnp.pad(mm_h.astype(jnp.int32), ((0, 0), (1, 0))), axis=1
    )  # [R, L+1] mism in read[0:s] vs LEFT side

    mm_t = (win_t[:, 2 : L + 2] != oriented.astype(jnp.uint32)) & inside
    cum_t = jnp.cumsum(
        jnp.pad(mm_t.astype(jnp.int32), ((0, 0), (1, 0))), axis=1
    )  # [R, L+1] mism in read[0:s] vs RIGHT side
    rev = jnp.flip(mm_t.astype(jnp.int32), axis=1)
    suffix = jnp.flip(jnp.cumsum(rev, axis=1), axis=1)
    suffix = jnp.concatenate([suffix, jnp.zeros((R, 1), jnp.int32)], axis=1)

    total = prefix + suffix  # [R, L+1] mismatches if split at s

    # donor/acceptor motifs at each split: fwd GT at head_pos+s, AG ending
    # at head_pos+D+s-1; rev CT / AC.  All read from the two windows:
    # d1,d2 = win_h[s], win_h[s+1]; a1,a2 = win_t[s], win_t[s+1]
    # (win_t starts at head_pos+D-2, so win_t[s] = genome[head_pos+D+s-2]).
    d1 = win_h[:, 0 : L + 1]
    d2 = win_h[:, 1 : L + 2]
    a1 = win_t[:, 0 : L + 1]
    a2 = win_t[:, 1 : L + 2]
    donor_fwd = (d1 == G) & (d2 == T) & (a1 == A) & (a2 == G)
    donor_rev = (d1 == C) & (d2 == T) & (a1 == A) & (a2 == C)

    s_grid = np.arange(L + 1, dtype=np.int32)[None, :]
    in_range = (s_grid >= W) & (s_grid <= read_len[:, None] - W)
    if guess_lo is not None:
        in_range = in_range & (s_grid >= guess_lo[:, None])
    if guess_hi is not None:
        in_range = in_range & (s_grid <= guess_hi[:, None])

    # 17-base confirm windows (clamped at the read edges by in_range)
    sW = jnp.clip(s_grid - W, 0, L)
    sPW = jnp.clip(s_grid + W, 0, L)
    take_at = lambda cum, idx: jnp.take_along_axis(
        cum, jnp.broadcast_to(idx, (R, L + 1)), axis=1
    )
    lmm = prefix[:, : L + 1] - take_at(prefix, sW)      # read[s-W:s] vs left
    rmm = take_at(cum_t, sPW) - cum_t[:, : L + 1]       # read[s:s+W] vs right
    lnm = take_at(prefix, sPW) - prefix[:, : L + 1]     # read[s:s+W] vs left
    rnm = cum_t[:, : L + 1] - take_at(cum_t, sW)        # read[s-W:s] vs right
    confirm = (lmm <= 1) & (lmm + rmm <= 1) & (lnm >= 5) & (rnm >= 5)

    # test_score = matched-own - matched-other; ties center-out (zig-zag
    # from the gap middle, left-of-center first)
    if guess_lo is not None and guess_hi is not None:
        center = ((guess_lo + guess_hi) // 2)[:, None]
    else:
        center = read_len[:, None] // 2
    dist_c = jnp.abs(s_grid - center)
    zig = 2 * dist_c - (s_grid < center)
    qual = (lnm + rnm - lmm - rmm) * jnp.int32(4 * L) - zig
    NEG = jnp.int32(-(1 << 28))
    qf = jnp.where(in_range & confirm & donor_fwd & valid[:, None], qual, NEG)
    qr = jnp.where(in_range & confirm & donor_rev & valid[:, None], qual, NEG)

    sf = jnp.argmax(qf, axis=1).astype(jnp.int32)
    vf = jnp.take_along_axis(qf, sf[:, None], axis=1)[:, 0]
    sr = jnp.argmax(qr, axis=1).astype(jnp.int32)
    vr = jnp.take_along_axis(qr, sr[:, None], axis=1)[:, 0]

    use_rev = vr > vf
    split = jnp.where(use_rev, sr, sf)
    best_q = jnp.where(use_rev, vr, vf)
    ok = best_q > NEG
    mism = jnp.take_along_axis(total, split[:, None], axis=1)[:, 0]
    mism = jnp.where(ok, mism, jnp.int32(1 << 20))

    # soft-clip noisy read ends of the junction explanation (the
    # reference emits e.g. 16M168N71M14S: find_soft_clipping applies to
    # explained reads too).  The combined mismatch vector stitches the
    # head half (< split) with the tail half (>= split); clips may not
    # consume an exon side below 8 bases (the split in_range floor).
    from .extend import softclip_bounds

    mm_comb = jnp.where(ar < split[:, None], mm_h, mm_t)
    cl, cr = softclip_bounds(mm_comb, read_len)
    cl = jnp.minimum(cl, jnp.maximum(split - 8, 0))
    cr = jnp.minimum(cr, jnp.maximum(read_len - split - 8, 0))
    no_clip = (cl + cr >= read_len - 16) | ~ok
    cl = jnp.where(no_clip, 0, cl)
    cr = jnp.where(no_clip, 0, cr)
    pc = jnp.cumsum(mm_comb.astype(jnp.int32), axis=1)
    head_mm = jnp.where(cl > 0, jnp.take_along_axis(
        pc, jnp.maximum(cl - 1, 0)[:, None], axis=1)[:, 0], 0)
    last_keep = jnp.clip(read_len - cr - 1, 0, L - 1)
    upto = jnp.take_along_axis(pc, last_keep[:, None], axis=1)[:, 0]
    mism_clipped = jnp.where(ok, jnp.maximum(upto - head_mm, 0), mism)

    return dict(
        split=split,
        mism=mism_clipped,
        clip_l=cl,
        clip_r=cr,
        donor_strand=use_rev.astype(jnp.int32),
        ok=ok,
    )


def pick_junction_pair(v, sc, max_indel: int, best=None, read_len=None):
    """From top-K clusters pick (head, tail) = best + best-compatible-minor.

    Returns per-read head_pos, gap D, pair_valid, head_k, tail_k.
    Compatibility: same strand, gap in (max_indel, MAX_INTRON], minor votes
    >= 1 (subjunc min-votes), coverage order consistent with genome order.
    `best` overrides the major cluster choice (the PE path passes the
    pair-selected candidate instead of the SE argmax)."""
    R, K = v.votes.shape
    if best is None:
        best = jnp.argmax(sc["score_k"], axis=1)  # major cluster index
    take = lambda a: jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
    b_pos = take(v.pos).astype(jnp.int64)
    b_strand = take(v.strand)
    b_cov_start = take(v.cov_start)
    b_valid = take(sc["valid_k"])

    # candidate minors: all k; the reference's exact compatibility
    # (test_junction_minor core-junction.c:889): strictly distinct
    # coverage start AND end, genome order consistent with read-coverage
    # order, minor votes <= major votes (copy_vote_to_alignment_res
    # :1086 "major half must be the anchor")
    pos_k = v.pos.astype(jnp.int64)
    same_strand = v.strand == b_strand[:, None]
    diff = pos_k - b_pos[:, None]
    not_self = jnp.arange(K)[None, :] != best[:, None]
    minor_is_tail = v.cov_start > b_cov_start[:, None]
    expected_sign = jnp.where(minor_is_tail, 1, -1)
    gap_abs = jnp.abs(diff)
    b_cov_end = take(v.cov_end)
    b_votes_m = take(v.votes)
    distinct_cov = (
        (v.cov_start != b_cov_start[:, None])
        & (v.cov_end != b_cov_end[:, None])
    )
    # coverage overlap <= 14 and |dist| >= 6 (the minor-scan gates,
    # core-junction.c:1193-1205)
    overlapped = jnp.where(
        minor_is_tail,
        b_cov_end[:, None] - v.cov_start,
        v.cov_end - b_cov_start[:, None],
    )
    ok = (
        same_strand & not_self & (v.votes >= 1) & distinct_cov
        & (v.votes <= b_votes_m[:, None])
        & (overlapped <= 14) & (gap_abs >= 6)
        & (gap_abs > max_indel) & (gap_abs <= MAX_INTRON)
        & (jnp.sign(diff) == expected_sign)
        & (v.pos != jnp.asarray(np.uint32(0xFFFFFFFF)))
    )
    # minor choice (is_better_inner :962): votes desc, coverage length
    # desc, intron length asc, first-in-table-order on full ties
    cov_len_m = (v.cov_end - v.cov_start).astype(jnp.int32)
    vc_m = jnp.where(
        ok, v.votes.astype(jnp.int32) * jnp.int32(1 << 10) + cov_len_m, -1
    )
    best_vc_m = jnp.max(vc_m, axis=1, keepdims=True)
    tie_m = ok & (vc_m == best_vc_m) & (best_vc_m >= 0)
    gap_pick_m = jnp.where(
        tie_m, gap_abs.astype(jnp.int32), jnp.int32(1 << 30)
    )
    minor_k = jnp.argmin(gap_pick_m, axis=1)
    minor_ok = jnp.any(tie_m, axis=1)
    m_pos = jnp.take_along_axis(pos_k, minor_k[:, None], axis=1)[:, 0]
    m_is_tail = jnp.take_along_axis(minor_is_tail, minor_k[:, None], axis=1)[:, 0]

    take_n = lambda a: jnp.take_along_axis(a, minor_k[:, None], axis=1)[:, 0]
    m_cov_start = take_n(v.cov_start)
    m_cov_end = take_n(v.cov_end)
    head_pos = jnp.where(m_is_tail, b_pos, m_pos)
    tail_pos = jnp.where(m_is_tail, m_pos, b_pos)
    gap = (tail_pos - head_pos).astype(jnp.int32)
    pair_valid = minor_ok & b_valid & (gap > 0)
    # donor_score split bounds: coverage gap +-8 (core-junction.c:1206-1210)
    guess_lo = jnp.where(m_is_tail, b_cov_end, m_cov_end) - 8
    guess_hi = jnp.where(m_is_tail, m_cov_start, b_cov_start) + 8

    # big-margin ambiguity (is_ambiguous_voting core-junction.c:3522):
    # another DISTINCT location within 1 vote of the best whose coverage
    # span matches the best cluster's span (containment either way, +-4,
    # spans flipped to forward-read coordinates for reverse clusters).
    # Junction minors cover a DIFFERENT part of the read, so they never
    # trip this; repeat copies of the SAME span do.
    ambiguous = jnp.zeros_like(pair_valid)
    if read_len is not None:
        b_votes_all = take(v.votes)
        b_cov_end = take(v.cov_end)
        L = read_len[:, None]
        cs_f = jnp.where(v.strand == 1, L - v.cov_end, v.cov_start)
        ce_f = jnp.where(v.strand == 1, L - v.cov_start, v.cov_end)
        b_cs = jnp.where(b_strand == 1, read_len - b_cov_end, b_cov_start)
        b_ce = jnp.where(b_strand == 1, read_len - b_cov_start, b_cov_end)
        ge = v.votes >= b_votes_all[:, None]
        within = (cs_f >= b_cs[:, None] - 4) & (ce_f <= b_ce[:, None] + 4)
        contains = (cs_f <= b_cs[:, None] + 4) & (ce_f >= b_ce[:, None] - 4)
        same_span = jnp.where(ge, within, contains)
        distinct = pos_k != b_pos[:, None]
        n_amb = jnp.sum(
            (v.votes >= b_votes_all[:, None] - 1) & same_span & distinct
            & (v.pos != jnp.asarray(np.uint32(0xFFFFFFFF))),
            axis=1,
        )
        ambiguous = n_amb >= 1

    return dict(
        head_pos=head_pos.astype(jnp.uint32),
        gap=gap,
        valid=pair_valid,
        strand=b_strand,
        best_pos=b_pos,
        best_votes=take(v.votes),
        ambiguous=ambiguous,
        guess_lo=guess_lo.astype(jnp.int32),
        guess_hi=guess_hi.astype(jnp.int32),
    )


def candidate_structure(v, read_len, min_votes_second: int = 1,
                        max_simples: int = 3):
    """The reference\'s per-read candidate bookkeeping, exactly
    (process_voting_junction_PE_topK, core-junction.c:2218-2300):

    - the vote table is scanned in TABLE order — row (creation_kv/5)%30
      ascending, slot creation order inside a row (v.anchor / v.apk carry
      both) — once per distinct top vote level (top_scores=3,
      core-indel.c:4415);
    - during the FIRST (top-level) pass every candidate with votes >= the
      3rd-highest distinct vote level is inserted into the 3-slot
      big-margin record (insert_big_margin_record :789: kept set = top-3
      by votes, equal-vote newcomers displace earlier records);
    - candidates of the pass level with votes >= minimum_subread_for_
      second_read append to the simple list, capped at max_vote_simples=3
      (core.c:4083) — and the cap BREAKS the scan, so big-margin inserts
      stop with it.  Inside a segmental duplication (2 copies x 2
      half-spans = 4 tied clusters) the 4th cluster therefore never
      enters the records: one half-span survives as a singleton whose
      stored result passes is_ambiguous_voting (:3522) and seeds the
      junction event, while both fully-recorded half-spans see
      encounter==2 and are suppressed.  This capacity quirk is how the
      reference finds junctions inside repeats yet rejects ordinary
      repeat reads;
    - stored alignment results = the simple entries, position-deduped, up
      to multi_best_reads=3 (:2440-2476 SE else-branch).

    Returns dict:
      simple   [R, K] bool — candidate is in the simple list
      stored_k [R, 3] int32 — candidate index per stored slot
      has_slot [R, 3] bool
      amb      [R, K] bool — is_ambiguous_voting per candidate
    """
    R, K = v.votes.shape
    SEN = jnp.asarray(np.uint32(0xFFFFFFFF))
    alive = v.pos != SEN
    votes = jnp.where(alive, v.votes.astype(jnp.int32), 0)
    karr = np.arange(K, dtype=np.int32)[None, :]

    # distinct top vote levels (update_top_three :909): top1 > top2 > top3
    top1 = jnp.max(votes, axis=1, keepdims=True)
    v2m = jnp.where(votes < top1, votes, 0)
    top2 = jnp.max(v2m, axis=1, keepdims=True)
    v3m = jnp.where(v2m < top2, v2m, 0)
    top3 = jnp.max(v3m, axis=1, keepdims=True)          # floor for big-margin

    # table order: row (creation kv / 5) % 30, then in-row creation order
    bucket = ((v.anchor // np.uint32(5)) % np.uint32(30)).astype(jnp.int32)
    apk = v.apk if getattr(v, "apk", None) is not None else karr + 0 * bucket
    tkey = jnp.where(alive, bucket * jnp.int32(1 << 16) + apk,
                     jnp.int32(1 << 30))
    torder = jnp.argsort(tkey, axis=1).astype(jnp.int32)   # [R, K] table scan
    trank = jnp.argsort(torder, axis=1).astype(jnp.int32)  # rank per candidate

    # first pass (top level) in table order: simple appends + the cap
    lvl_ok = votes >= jnp.maximum(top1 - 2, 1)
    simple_cand = alive & (votes >= min_votes_second)
    s0 = simple_cand & (votes == top1)
    s0_t = jnp.take_along_axis(s0, torder, axis=1)
    cum0 = jnp.cumsum(s0_t.astype(jnp.int32), axis=1)
    appended0_t = s0_t & (cum0 <= max_simples)
    # big-margin inserts happen before the append in the same iteration:
    # processed while fewer than max_simples appends had completed
    processed_t = (cum0 - s0_t.astype(jnp.int32)) < max_simples
    votes_t = jnp.take_along_axis(votes, torder, axis=1)
    alive_t = jnp.take_along_axis(alive, torder, axis=1)
    bm_t = processed_t & alive_t & (votes_t >= jnp.take_along_axis(
        jnp.broadcast_to(top3, votes.shape), torder, axis=1))
    # later passes (top2, top3 levels within the vote cutoff): appends only
    n0 = jnp.sum(appended0_t, axis=1, keepdims=True)
    s1_t = jnp.take_along_axis(
        simple_cand & (votes == top2) & (top2 > 0), torder, axis=1)
    cum1 = jnp.cumsum(s1_t.astype(jnp.int32), axis=1)
    appended1_t = s1_t & (n0 + cum1 <= max_simples)
    n1 = n0 + jnp.sum(appended1_t, axis=1, keepdims=True)
    s2_t = jnp.take_along_axis(
        simple_cand & (votes == top3) & (top3 > 0), torder, axis=1)
    cum2 = jnp.cumsum(s2_t.astype(jnp.int32), axis=1)
    appended2_t = s2_t & (n1 + cum2 <= max_simples)
    simple_t = appended0_t | appended1_t | appended2_t
    # un-permute back to candidate indexing; apply the vote-level cutoff
    # (max_vote_number_cutoff=2: levels below top-2 break out, :2266)
    simple = jnp.take_along_axis(simple_t, trank, axis=1) & lvl_ok
    bm_ins = jnp.take_along_axis(bm_t, trank, axis=1)

    # big-margin kept records = top-3 inserted by (votes, recency): an
    # equal-vote newcomer displaces older records, the overflow drops off
    # the tail — so later TABLE rank wins among equal votes
    keep_key = jnp.where(bm_ins, votes * jnp.int32(64) + trank, -1)
    order3 = jnp.argsort(-keep_key, axis=1)[:, :3]
    rec_ok = jnp.take_along_axis(keep_key, order3, axis=1) >= 0
    rv = jnp.take_along_axis(votes, order3, axis=1)
    L = read_len[:, None]
    cs_f = jnp.where(v.strand == 1, L - v.cov_end, v.cov_start)
    ce_f = jnp.where(v.strand == 1, L - v.cov_start, v.cov_end)
    rcs = jnp.take_along_axis(cs_f, order3, axis=1)
    rce = jnp.take_along_axis(ce_f, order3, axis=1)

    # encounter (is_ambiguous_voting :3536-3566): records with votes >=
    # candidate-1 whose span matches directionally within +-4, in
    # forward-read coordinates
    vk = votes[:, :, None]
    vj = rv[:, None, :]
    csk, cek = cs_f[:, :, None], ce_f[:, :, None]
    csj, cej = rcs[:, None, :], rce[:, None, :]
    inside = (csj >= csk - 4) & (cej <= cek + 4)
    contains = (csj <= csk + 4) & (cej >= cek - 4)
    span_match = jnp.where(vk >= vj, inside, contains)
    enc = jnp.sum(
        (vj >= vk - 1) & rec_ok[:, None, :] & span_match, axis=2
    )
    amb = (enc > 1) & alive

    # stored slots: simple entries in simple-list order (= the candidate
    # order: vote level desc, then table order), position-deduped, up to 3
    pos = v.pos.astype(jnp.int64)
    earlier = karr[0][None, :, None] < karr[0][None, None, :]
    dup = jnp.any(
        (pos[:, :, None] == pos[:, None, :]).transpose(0, 2, 1)
        & earlier.transpose(0, 2, 1) & simple[:, None, :],
        axis=2,
    )
    stored = simple & ~dup
    rank = jnp.cumsum(stored.astype(jnp.int32), axis=1) - 1
    stored = stored & (rank < 3)
    slots = []
    for s in range(3):
        slots.append(jnp.argmax(stored & (rank == s), axis=1).astype(jnp.int32))
    stored_k = jnp.stack(slots, axis=1)
    has_slot = (
        jnp.take_along_axis(stored, stored_k, axis=1)
        & (jnp.take_along_axis(rank, stored_k, axis=1)
           == np.arange(3, dtype=np.int32)[None, :])
    )
    return dict(simple=simple, stored_k=stored_k, has_slot=has_slot, amb=amb)


def big_margin_ambiguous(v, read_len, min_votes_second: int = 1):
    """[R, K] `is_ambiguous_voting` flags (see candidate_structure)."""
    return candidate_structure(v, read_len, min_votes_second)["amb"]


def pick_stored_seed_junctions(v, sc, max_indel: int, read_len, cand_ok,
                               min_votes: int = 1,
                               min_votes_second: int = 1,
                               max_simples: int = 3):
    """Per-STORED-candidate junction seeding, the reference shape:
    find_new_junctions runs once per stored alignment result
    (core.c:3249-3278 best_read_id 0..multi_best_reads-1,
    core-junction.c:3836).  Stored results and the 3-slot ambiguity gate
    come from candidate_structure (exact table-scan semantics).  Each
    stored result carries its OWN minor half from the full cluster table
    (copy_vote_to_alignment_res minor scan, core-junction.c:1078-1160):
    minor votes <= major votes, strictly distinct coverage start AND end
    (test_junction_minor :889), genome order consistent with
    read-coverage order, picked by votes desc, then coverage length
    desc, then intron length asc (is_better_inner :962),
    first-in-table-order on full ties.

    Returns dict of [R, 3] arrays: head_pos (uint32 genome-left cluster
    anchor), gap (int32 > 0), strand, valid.
    """
    R, K = v.votes.shape
    cs = candidate_structure(v, read_len, min_votes_second, max_simples)
    SEN = jnp.asarray(np.uint32(0xFFFFFFFF))
    alive = v.pos != SEN
    votes = jnp.where(alive, v.votes.astype(jnp.int32), 0)
    pos = v.pos.astype(jnp.int64)

    # reference minor compatibility [R, Kmajor, Kminor]
    same_strand = v.strand[:, :, None] == v.strand[:, None, :]
    diff = pos[:, None, :] - pos[:, :, None]                # minor - major
    not_self = ~jnp.eye(K, dtype=bool)[None]
    gap_abs = jnp.abs(diff)
    cs_m, ce_m = v.cov_start, v.cov_end
    distinct_cov = (
        (cs_m[:, None, :] != cs_m[:, :, None])
        & (ce_m[:, None, :] != ce_m[:, :, None])
    )
    minor_is_tail = cs_m[:, None, :] > cs_m[:, :, None]
    expected_sign = jnp.where(minor_is_tail, 1, -1)
    # coverage overlap <= 14 and |dist| >= 6 (core-junction.c:1193-1205)
    overlapped = jnp.where(
        minor_is_tail,
        ce_m[:, :, None] - cs_m[:, None, :],
        ce_m[:, None, :] - cs_m[:, :, None],
    )
    ok = (
        same_strand & not_self & distinct_cov
        & (votes[:, None, :] >= 1)
        & (votes[:, None, :] <= votes[:, :, None])          # minor <= major
        & (overlapped <= 14) & (gap_abs >= 6)
        & (gap_abs > max_indel) & (gap_abs <= MAX_INTRON)
        & (jnp.sign(diff) == expected_sign)
        & alive[:, None, :] & alive[:, :, None]
    )
    # minor choice per major: votes desc, coverage length desc, intron
    # asc, then first in table order (= lowest k among equal-vote
    # candidates, whose order matches the table scan)
    cov_len = (ce_m - cs_m).astype(jnp.int32)               # [R, K]
    vc = votes[:, None, :] * jnp.int32(1 << 10) + cov_len[:, None, :]
    vc = jnp.where(ok, vc, -1)
    best_vc = jnp.max(vc, axis=2, keepdims=True)
    tie = ok & (vc == best_vc) & (best_vc >= 0)
    gap_pick = jnp.where(tie, gap_abs.astype(jnp.int32), jnp.int32(1 << 30))
    minor_k = jnp.argmin(gap_pick, axis=2)                  # [R, Kmajor]
    minor_found = jnp.any(tie, axis=2)

    slot_k = cs["stored_k"]
    take_s = lambda a: jnp.take_along_axis(a, slot_k, axis=1)
    s_pos = take_s(pos)
    s_minor_k = take_s(minor_k)
    m_pos = jnp.take_along_axis(pos, s_minor_k, axis=1)
    m_is_tail = m_pos > s_pos
    head_pos = jnp.where(m_is_tail, s_pos, m_pos)
    gap = (jnp.where(m_is_tail, m_pos, s_pos) - head_pos).astype(jnp.int32)
    valid = (
        cs["has_slot"] & ~take_s(cs["amb"]) & take_s(minor_found)
        & take_s(cand_ok) & (take_s(votes) >= min_votes) & (gap > 0)
    )
    # donor_score split bounds per slot: coverage gap +-8 in read coords
    s_cs, s_ce = take_s(cs_m), take_s(ce_m)
    m_cs = jnp.take_along_axis(cs_m, s_minor_k, axis=1)
    m_ce = jnp.take_along_axis(ce_m, s_minor_k, axis=1)
    m_read_tail = m_cs > s_cs          # minor covers the later read part
    guess_lo = jnp.where(m_read_tail, s_ce, m_ce) - 8
    guess_hi = jnp.where(m_read_tail, m_cs, s_cs) + 8
    return dict(
        head_pos=head_pos.astype(jnp.uint32),
        gap=gap,
        strand=take_s(v.strand),
        valid=valid,
        guess_lo=guess_lo.astype(jnp.int32),
        guess_hi=guess_hi.astype(jnp.int32),
    )


def junction_rescue(
    genome_u32: jnp.ndarray,
    oriented: jnp.ndarray,    # [R, L] read codes in genome orientation
    read_len: jnp.ndarray,    # [R]
    pos: jnp.ndarray,         # [R] uint32 anchor alignment start
    ev_left: jnp.ndarray,     # [E] uint32 sorted junction left edges (linear)
    ev_right: jnp.ndarray,    # [E] uint32 matching right edges
    n_cand: int = 4,
):
    """Re-explain reads against the global junction event table.

    Reference: explain_read / search_events_to_back-front
    (core-junction.c:2617, :125, :588) — scan 2 walks the event space
    around each read's anchor so reads WITHOUT their own minor vote
    cluster still get junction CIGARs, and junction support counts include
    them.  Here: the n_cand events whose left edge falls inside the read
    span are tested with the fixed-split mismatch scan; the best
    (fewest-mismatch) event wins.

    Returns dict(mism, split, gap, ok) for the best event per read.
    """
    R, L = oriented.shape
    E = ev_left.shape[0]
    ar = np.arange(L, dtype=np.int32)[None, :]
    inside = ar < read_len[:, None]

    # head mismatch prefix (read i vs genome pos+i)
    win_h = genome_window(genome_u32, pos, L)
    mm_h = (win_h != oriented.astype(jnp.uint32)) & inside
    prefix = jnp.cumsum(
        jnp.pad(mm_h.astype(jnp.int32), ((0, 0), (1, 0))), axis=1
    )  # [R, L+1]

    # candidate events: left edge anywhere inside the read span — the
    # reference explains flanking exons down to a single base
    # (explain_read emits e.g. 100M1194N1M), so split in [1, len-1]
    first = jnp.searchsorted(ev_left, pos)                 # [R]
    cidx = jnp.minimum(first[:, None] + np.arange(n_cand, dtype=np.int32), E - 1)
    c_left = ev_left[cidx]    # [R, n_cand]
    c_right = ev_right[cidx]
    split = (c_left - pos[:, None] + np.uint32(1)).astype(jnp.int32)  # [R, C]
    gap = (c_right - c_left - np.uint32(1)).astype(jnp.int32)
    valid = (
        (split >= 1)
        & (split <= read_len[:, None] - 1)
        & (gap > 0)
        & (cidx < E)
    )

    # fused ranking: mismatches first, PROXIMITY as tie-break (identical
    # repeat copies of a flanking exon otherwise win longer introns);
    # mism*2^20 + gap fits int32 (gap <= MAX_INTRON < 2^20)
    BIG = jnp.int32(1 << 30)
    best_score = jnp.full((R,), 1 << 30, jnp.int32)
    best_mism = jnp.full((R,), 1 << 20, jnp.int32)
    best_split = jnp.zeros((R,), jnp.int32)
    best_gap = jnp.zeros((R,), jnp.int32)
    best_pos = pos
    for c in range(n_cand):
        # tail mismatches under genome offset gap_c: read i vs pos+i+gap
        g_tail = genome_window(
            genome_u32, pos + gap[:, c].astype(jnp.uint32), L
        )
        mm_t = (g_tail != oriented.astype(jnp.uint32)) & inside
        rev = jnp.flip(mm_t.astype(jnp.int32), axis=1)
        suffix = jnp.flip(jnp.cumsum(rev, axis=1), axis=1)  # [R, L]
        suffix = jnp.concatenate(
            [suffix, jnp.zeros((R, 1), jnp.int32)], axis=1
        )
        s_c = jnp.clip(split[:, c], 0, L)
        m = jnp.take_along_axis(prefix, s_c[:, None], axis=1)[:, 0] + \
            jnp.take_along_axis(suffix, s_c[:, None], axis=1)[:, 0]
        score = jnp.where(valid[:, c], m * (1 << 20) + gap[:, c], BIG)
        better = score < best_score
        best_score = jnp.where(better, score, best_score)
        best_mism = jnp.where(better & valid[:, c], m, best_mism)
        best_split = jnp.where(better, split[:, c], best_split)
        best_gap = jnp.where(better, gap[:, c], best_gap)

    # mirrored arm (search_events_to_front): the read anchors the RIGHT
    # exon; a table junction whose right edge falls inside the read span
    # explains the prefix as the LEFT exon's tail.  The anchor moves to
    # le - split + 1.
    r_order = jnp.argsort(ev_right)
    evr_sorted = ev_right[r_order]
    evl_sorted = ev_left[r_order]
    first_r = jnp.searchsorted(evr_sorted, pos + np.uint32(1))
    cidx_r = jnp.minimum(
        first_r[:, None] + np.arange(n_cand, dtype=np.int32), E - 1
    )
    cr_right = evr_sorted[cidx_r]   # [R, C]
    cr_left = evl_sorted[cidx_r]
    split_r = (cr_right - pos[:, None]).astype(jnp.int32)
    gap_r = (cr_right - cr_left - np.uint32(1)).astype(jnp.int32)
    valid_r = (
        (split_r >= 1)
        & (split_r <= read_len[:, None] - 1)
        & (gap_r > 0)
        & (cidx_r < E)
    )
    # suffix mismatches of the CURRENT (right-exon) alignment
    rev_h = jnp.flip(mm_h.astype(jnp.int32), axis=1)
    suffix_h = jnp.flip(jnp.cumsum(rev_h, axis=1), axis=1)
    suffix_h = jnp.concatenate(
        [suffix_h, jnp.zeros((R, 1), jnp.int32)], axis=1
    )
    for c in range(n_cand):
        new_start = (
            cr_left[:, c] - split_r[:, c].astype(jnp.uint32) + np.uint32(1)
        )
        g_head = genome_window(genome_u32, new_start, L)
        mm_p = (g_head != oriented.astype(jnp.uint32)) & inside
        pre2 = jnp.cumsum(
            jnp.pad(mm_p.astype(jnp.int32), ((0, 0), (1, 0))), axis=1
        )
        s_c = jnp.clip(split_r[:, c], 0, L)
        m = jnp.take_along_axis(pre2, s_c[:, None], axis=1)[:, 0] + \
            jnp.take_along_axis(suffix_h, s_c[:, None], axis=1)[:, 0]
        score = jnp.where(valid_r[:, c], m * (1 << 20) + gap_r[:, c], BIG)
        better = score < best_score
        best_score = jnp.where(better, score, best_score)
        best_mism = jnp.where(better & valid_r[:, c], m, best_mism)
        best_split = jnp.where(better, split_r[:, c], best_split)
        best_gap = jnp.where(better, gap_r[:, c], best_gap)
        best_pos = jnp.where(better, new_start, best_pos)

    # soft-clip fold on the winning stitched explanation (the reference's
    # find_soft_clipping applies to explained reads: e.g. 12S61M84N28M);
    # clips may not consume a flank entirely (>= 1 aligned base each side)
    from .extend import softclip_bounds

    ok = best_score < BIG
    g_head_w = genome_window(genome_u32, best_pos, L)
    mm_hw = (g_head_w != oriented.astype(jnp.uint32)) & inside
    g_tail_w = genome_window(
        genome_u32, best_pos + best_gap.astype(jnp.uint32), L
    )
    mm_tw = (g_tail_w != oriented.astype(jnp.uint32)) & inside
    mm_comb = jnp.where(ar < best_split[:, None], mm_hw, mm_tw)
    cl, cr = softclip_bounds(mm_comb, read_len)
    cl = jnp.minimum(cl, jnp.maximum(best_split - 1, 0))
    cr = jnp.minimum(cr, jnp.maximum(read_len - best_split - 1, 0))
    no_clip = (cl + cr >= read_len - 16) | ~ok
    cl = jnp.where(no_clip, 0, cl)
    cr = jnp.where(no_clip, 0, cr)
    pc = jnp.cumsum(mm_comb.astype(jnp.int32), axis=1)
    head_mm = jnp.where(cl > 0, jnp.take_along_axis(
        pc, jnp.maximum(cl - 1, 0)[:, None], axis=1)[:, 0], 0)
    last_keep = jnp.clip(read_len - cr - 1, 0, L - 1)
    upto = jnp.take_along_axis(pc, last_keep[:, None], axis=1)[:, 0]
    mism_clipped = jnp.where(ok, jnp.maximum(upto - head_mm, 0), best_mism)

    return dict(
        mism=mism_clipped, split=best_split, gap=best_gap, pos=best_pos,
        clip_l=cl, clip_r=cr,
        ok=ok,
    )
