"""Scan-2 realignment: mismatch scoring, indel split placement, soft-clips.

Reference equivalents: `explain_read`/`finalise_explain_CIGAR`
(core-junction.c:2617,3159) and the banded DP `core_dynamic_align`
(core-indel.c:4573-4787).  The reference's scoring for that DP is
match +2, mismatch 0, gap-open −1, gap-extend 0 — i.e. a single indel of
any length costs 1 and the optimum simply maximises matched bases.  For a
known net indel size (from the vote cluster's head/tail sections) the
optimal single-indel placement is therefore the split point s minimising
head-mismatches(0..s) + tail-mismatches(s..L): an O(L) prefix/suffix
cumulative-sum scan instead of an O(L·band) DP — dense and branchless.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def genome_base(genome_u32: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """Fetch 2-bit bases at linear positions (any shape).  Layout: base i at
    bits (i%16)*2 of word i//16 (gene-value-index.c:43)."""
    pos = pos.astype(jnp.uint32)
    word = genome_u32[jnp.minimum(pos >> 4, len(genome_u32) - 1)]
    return (word >> ((pos & 15) << 1)) & 3


def genome_window(genome_u32: jnp.ndarray, start: jnp.ndarray, L: int) -> jnp.ndarray:
    """Bases of genome[start : start+L] per row — [R, L] uint32.

    Gathers only ceil(L/16)+1 packed words per row, then realigns to the
    in-word phase with elementwise bit shifts (word j of the shifted
    stream holds bases start+16j .. start+16j+15) and unpacks with static
    shifts.  Everything after the word gather is elementwise — no second
    gather.  (An earlier variant that materialised unpacked bases and
    realigned rows with vmapped dynamic_slice measured SLOWER than per-base
    scalar gathers: XLA lowers the per-row realignment slice to a gather of
    the same element count, so it paid both costs.)
    """
    start = start.astype(jnp.uint32)
    nw = L // 16 + 2
    G = len(genome_u32)
    w0 = jnp.minimum(start >> 4, np.uint32(max(G - nw, 0)))
    if G % 8 == 0:
        # ROW-gather fast path: fetch [NR, 8]-word rows instead of scalar
        # words (the same layout as vote.gather_hits' combined index
        # rows); the per-row word phase is fixed up with a static 3-step
        # shift ladder.
        rows = genome_u32.reshape(-1, 8)
        NR = (nw + 7) // 8 + 1
        r0 = (w0 >> 3).astype(jnp.int32)
        ridx = jnp.minimum(
            r0[:, None] + np.arange(NR, dtype=np.int32), rows.shape[0] - 1
        )
        wflat = rows[ridx].reshape(-1, NR * 8)  # the only gather
        wph = (w0 & 7)[:, None]
        for b in (4, 2, 1):
            on = (wph & b) != 0
            wflat = jnp.where(
                on, jnp.pad(wflat[:, b:], ((0, 0), (0, b))), wflat
            )
        w = wflat[:, :nw]
    else:
        widx = w0[:, None] + np.arange(nw, dtype=np.uint32)[None, :]
        w = genome_u32[widx]  # [R, nw]
    ph = ((start & 15) << 1).astype(jnp.uint32)[:, None]  # bit phase (2 bits/base)
    shifted = (w[:, :-1] >> ph) | jnp.where(
        ph > 0, w[:, 1:] << (np.uint32(32) - ph), np.uint32(0)
    )  # [R, nw-1]
    base_sh = (np.uint32(2) * np.arange(16, dtype=np.uint32))[None, None, :]
    bases = ((shifted[:, :, None] >> base_sh) & 3).reshape(
        shifted.shape[0], (nw - 1) * 16
    )
    return bases[:, :L]


def oriented_read(
    codes: jnp.ndarray, read_len: jnp.ndarray, strand: jnp.ndarray,
    uniform_len: int | None = None,
) -> jnp.ndarray:
    """Read codes in genome orientation: reverse-complemented where strand=1.

    codes [R, L] uint8, read_len [R], strand [R] → [R, L] (pad right).
    With `uniform_len` (every real read the same length — the common case)
    the reversal is a static flip instead of a [R, L] gather (measured
    ~12ms per 8192x128 batch on the gather path)."""
    R, L = codes.shape
    if uniform_len is not None:
        rc = (3 - jnp.flip(codes[:, :uniform_len], axis=1)).astype(codes.dtype)
        if L > uniform_len:
            rc = jnp.pad(rc, ((0, 0), (0, L - uniform_len)))
    else:
        ridx = read_len[:, None] - 1 - jnp.arange(L, dtype=jnp.int32)[None, :]
        rc = (3 - jnp.take_along_axis(codes, jnp.clip(ridx, 0, L - 1), axis=1)).astype(
            codes.dtype
        )
    return jnp.where(strand[:, None] == 1, rc, codes)


def mismatch_matrix(
    genome_u32: jnp.ndarray,
    oriented: jnp.ndarray,   # [R, L] codes in genome orientation
    read_len: jnp.ndarray,   # [R]
    pos: jnp.ndarray,        # [R] uint32 alignment start (head section)
) -> jnp.ndarray:
    """bool [R, L]: mismatch of read base i vs genome base pos+i (False
    beyond read_len)."""
    R, L = oriented.shape
    g = genome_window(genome_u32, pos, L)
    mm = g != oriented.astype(jnp.uint32)
    inside = np.arange(L, dtype=np.int32)[None, :] < read_len[:, None]
    return mm & inside


def place_single_indel(
    genome_u32: jnp.ndarray,
    oriented: jnp.ndarray,
    read_len: jnp.ndarray,
    head_pos: jnp.ndarray,   # [R] uint32
    indel: jnp.ndarray,      # [R] int32 net indel: >0 deletion, <0 insertion
    max_indel_static: int = 16,  # static |indel| bound (config max_indel)
    return_head_prefix: bool = False,
) -> tuple[jnp.ndarray, ...]:
    """Optimal split s for a single indel of known size.

    Head segment read[0:s] aligns at head_pos; tail segment read[s':L]
    aligns at head_pos + s' + indel (s' = s for deletions, s + |indel| for
    insertions, whose inserted bases consume read only).  Returns
    (split [R] int32, total_mismatches [R] int32) excluding inserted bases.
    """
    R, L = oriented.shape
    ar = jnp.arange(L, dtype=jnp.int32)[None, :]
    inside = ar < read_len[:, None]

    # head mismatches: read i ↔ genome head_pos + i
    mm_head = mismatch_matrix(genome_u32, oriented, read_len, head_pos)
    # prefix[i] = mismatches in read[0:i], shape [R, L+1]
    prefix = jnp.cumsum(
        jnp.pad(mm_head.astype(jnp.int32), ((0, 0), (1, 0))), axis=1
    )

    # tail mismatches: read i ↔ genome head_pos + i + indel (uint32 modular
    # arithmetic; genuine positions never underflow because head_pos >= the
    # 1210-base contig padding)
    g_tail = genome_window(
        genome_u32, head_pos.astype(jnp.uint32) + indel.astype(jnp.uint32), L
    )
    mm_tail = (g_tail != oriented.astype(jnp.uint32)) & inside
    # suffix[i] = mismatches in read[i:L] under the tail alignment
    rev = jnp.flip(mm_tail.astype(jnp.int32), axis=1)
    suffix = jnp.flip(jnp.cumsum(rev, axis=1), axis=1)  # [R, L], suffix[i] = sum i..L-1
    suffix = jnp.concatenate([suffix, jnp.zeros((R, 1), jnp.int32)], axis=1)  # [R, L+1]

    ins_len = jnp.maximum(-indel, 0)[:, None]  # inserted read bases skip scoring
    s_grid = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    # suffix shifted left by ins_len per row, i.e. suffix[min(s+ins, L)].
    # ins_len is tiny and bounded (|indel| <= max_indel), so a static-shift
    # where-chain stays elementwise — a take_along_axis here would gather
    # [R, L+1] elements, which measured ~40ms per 32K-candidate batch.
    max_ins = int(max_indel_static)
    tail_sel = suffix
    for k in range(1, max_ins + 1):
        sh_k = jnp.pad(suffix[:, k:], ((0, 0), (0, k)))  # zeros: suffix[L]=0
        tail_sel = jnp.where(ins_len == k, sh_k, tail_sel)
    total = prefix + tail_sel
    # valid split range: 1 <= s <= read_len - 1 - ins_len (both segments nonempty)
    valid = (s_grid >= 1) & (s_grid + ins_len <= read_len[:, None] - 1)
    total = jnp.where(valid, total, 1 << 20)
    split = jnp.argmin(total, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(total, split[:, None], axis=1)[:, 0]
    if return_head_prefix == "mm":
        # full per-base mismatch matrices for the reference clip/mismatch
        # semantics (ref_clip_stats below) — no extra genome gathers
        return split, best, mm_head, mm_tail
    if return_head_prefix:
        # the head-alignment mismatch prefix table doubles as the final
        # alignment's profile for indel-free candidates — softclip bounds
        # can then be derived without a second genome gather
        return split, best, prefix
    return split, best


# reference soft-clip scan constants (core-junction.c:2816-2817)
_SC_WINDOW = 5
_SC_MAX_ERROR = 1


def ref_clip_stats(
    mm_head: jnp.ndarray,    # bool [R, L] mismatch vs genome at pos+i
    mm_tail: jnp.ndarray,    # bool [R, L] mismatch vs genome at pos+i+indel
    read_len: jnp.ndarray,   # [R]
    split: jnp.ndarray,      # [R] single-indel split (read coord); ignored
    #                          when indel == 0
    indel: jnp.ndarray,      # [R] int32 (>0 del, <0 ins, 0 none)
    cov_start: jnp.ndarray,  # [R] confident coverage start (read coord)
    cov_end: jnp.ndarray,    # [R] confident coverage end (read coord)
    show_clip: bool = True,
):
    """The reference's final-alignment statistics, exactly.

    Implements find_soft_clipping (core-junction.c:2820, window=5 max_err=1,
    scanning outward from the confident vote coverage bounds) and the
    mismatch/match accounting of final_CIGAR_quality (:2899): mismatches
    counted over M-section bases outside the clipped ends; matched bases =
    non_clipped_len - mismatches - inserted bases.

    Returns (head_clip, tail_clip, mism, match) int32 [R].
    """
    R, L = mm_head.shape
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    rl = read_len[:, None].astype(jnp.int32)
    ins = jnp.maximum(-indel, 0)[:, None]
    single = (indel == 0)[:, None]
    splitc = jnp.where(single, rl, split[:, None])
    # first read base of the LAST M section (single-section reads: the one
    # section is both first and last — both scans run over [0, rl))
    sec2_start = jnp.where(single, 0, splitc + ins)
    # final-alignment mismatch bitmap over M-section bases
    in_sec1 = j < splitc
    in_sec2 = (j >= sec2_start) & (j < rl)
    mm = jnp.where(in_sec1, mm_head, mm_tail) & (in_sec1 | in_sec2)
    mt = (~mm) & (in_sec1 | in_sec2)                 # matched M bases

    # ---- head scan (first M section, test_len = splitc) -----------------
    test1 = splitc
    c0 = cov_start[:, None].astype(jnp.int32)
    s0h = jnp.where(c0 < 0, 0, jnp.where(c0 >= test1, test1 - 1, c0 + 1))
    # windowed mismatch count over examined bases [i, min(i+W-1, s0h)]:
    # mmh is zero past s0h, so the clamped upper bound falls out of a plain
    # 5-wide sum of static left shifts — no cumsum, no take_along_axis
    # gathers (a [R, L] take_along_axis here measured ~70ms per 64K x 100
    # candidate batch; the whole scan is elementwise now)
    mmh = (mm & (j <= s0h)).astype(jnp.int32)
    win_h = mmh
    for dsh in range(1, _SC_WINDOW):
        win_h = win_h + jnp.pad(mmh[:, dsh:], ((0, 0), (0, dsh)))
    trip_h = (win_h > _SC_MAX_ERROR) & (j <= s0h)
    tripped_h = jnp.any(trip_h, axis=1, keepdims=True)
    jt_h = jnp.max(jnp.where(trip_h, j, -1), axis=1, keepdims=True)
    lo_h = jnp.where(tripped_h, jt_h, 0)
    m_h = mt & (j >= lo_h) & (j <= s0h)
    has_m_h = jnp.any(m_h, axis=1, keepdims=True)
    lm_h = jnp.min(jnp.where(m_h, j, 1 << 20), axis=1, keepdims=True)
    head = jnp.where(
        has_m_h, lm_h, jnp.where(tripped_h, s0h - 1, test1)
    )
    head = jnp.where(head >= test1, 0, head)         # full-section clip → 0
    head = jnp.maximum(head, 0)

    # ---- tail scan (last M section) --------------------------------------
    test2 = rl - sec2_start
    c1 = cov_end[:, None].astype(jnp.int32) - sec2_start
    s0t_rel = jnp.where(c1 < 0, 0, jnp.where(c1 >= test2, test2 - 1, c1 - 1))
    s0t = sec2_start + s0t_rel                       # absolute read coord
    # windowed count over [max(i-W+1, s0t), i]: mmt is zero before s0t, so
    # the clamp falls out of a 5-wide sum of static right shifts (see head
    # scan note — no cumsum/gather)
    mmt = (mm & (j >= s0t)).astype(jnp.int32)
    win_t = mmt
    for dsh in range(1, _SC_WINDOW):
        win_t = win_t + jnp.pad(mmt[:, :-dsh], ((0, 0), (dsh, 0)))
    trip_t = (win_t > _SC_MAX_ERROR) & (j >= s0t) & (j < rl)
    tripped_t = jnp.any(trip_t, axis=1, keepdims=True)
    jt_t = jnp.min(jnp.where(trip_t, j, 1 << 20), axis=1, keepdims=True)
    hi_t = jnp.where(tripped_t, jt_t, rl - 1)
    m_t = mt & (j <= hi_t) & (j >= s0t)
    has_m_t = jnp.any(m_t, axis=1, keepdims=True)
    lm_t = jnp.max(jnp.where(m_t, j, -1), axis=1, keepdims=True)
    tail = jnp.where(
        has_m_t, rl - 1 - lm_t,
        jnp.where(tripped_t, test2 - s0t_rel, test2),
    )
    tail = jnp.where(tail >= test2, 0, tail)
    tail = jnp.maximum(tail, 0)

    if not show_clip:
        head = jnp.zeros_like(head)
        tail = jnp.zeros_like(tail)
    else:
        # single-M rule: clipping (almost) everything → clip nothing
        both_gone = single & (head + tail >= rl - 1)
        head = jnp.where(both_gone, 0, head)
        tail = jnp.where(both_gone, 0, tail)

    # ---- mismatch / match over the non-clipped M region -------------------
    keep = (j >= head) & (j < rl - tail)
    mism = jnp.sum(mm & keep, axis=1).astype(jnp.int32)
    ins_f = jnp.maximum(-indel, 0)
    non_clipped = read_len.astype(jnp.int32) - head[:, 0] - tail[:, 0]
    match = non_clipped - mism - ins_f
    return head[:, 0], tail[:, 0], mism, match


def softclip_from_prefix(
    prefix: jnp.ndarray,     # int32 [R, L+1]: prefix[b] = head-alignment
    #                          mismatches in read[0:b], masked to read_len
    read_len: jnp.ndarray,   # [R]
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """softclip_bounds computed from an existing mismatch prefix table.

    Same max-scoring-window (Kadane) semantics as softclip_bounds, but
    reusing the prefix sums place_single_indel already built — so the
    pipeline's softclip stage needs no second genome-window gather.  Valid
    for indel-free candidates, whose head alignment IS the final alignment.
    Returns (clip_left, clip_right, mismatches inside the kept window).
    """
    R, L1 = prefix.shape
    L = L1 - 1
    idx = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    # S[b] = sum over read[0:b] of (mismatch ? -3 : +1), zero past read_len:
    # matches in [0,b) = min(b, len) - prefix[b]  ->  S = min(b,len) - 4*prefix
    S = jnp.minimum(idx, read_len[:, None]) - 4 * prefix
    pm = jax.lax.cummin(S, axis=1)
    gain = S - pm
    b = jnp.argmax(gain, axis=1).astype(jnp.int32)
    minv = jnp.take_along_axis(pm, b[:, None], axis=1)[:, 0]
    a = jnp.argmax((S == minv[:, None]) & (idx <= b[:, None]), axis=1).astype(
        jnp.int32
    )
    clip_left = a
    clip_right = jnp.maximum(read_len - b, 0)
    too_much = clip_left + clip_right >= read_len
    clip_left = jnp.where(too_much, 0, clip_left)
    clip_right = jnp.where(too_much, 0, clip_right)
    last = jnp.clip(read_len - clip_right, 0, L)
    m_ab = (
        jnp.take_along_axis(prefix, last[:, None], axis=1)[:, 0]
        - jnp.take_along_axis(prefix, jnp.minimum(clip_left, L)[:, None], axis=1)[:, 0]
    )
    return clip_left, clip_right, jnp.maximum(m_ab, 0)


def softclip_bounds(
    mm: jnp.ndarray,         # bool [R, L] mismatch profile of the final alignment
    read_len: jnp.ndarray,   # [R]
    max_edge_mm: int = 3,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Soft-clip bounds (clip_left, clip_right) per read.

    Serves the reference's covered-region clipping
    (gene-algorithms.h:102 find_soft_clipping semantics) but computed as
    the max-scoring window: keep the contiguous window [a, b) maximising
    match - 3*mismatch (positive exactly when window mismatch density
    < 1/4) and clip what falls outside it.  Unlike an inward density
    scan, this isolates a clean anchored half even when the dirty edge
    is long enough to dominate the whole-read density (a read straddling
    a long indel: one half clean, the other ~75% mismatching — the basis
    for the iteration-three long-indel rescue, core-indel.c:4389).
    Vectorised Kadane: prefix sums + running minimum; ties prefer the
    smallest clip on both sides.
    """
    import jax

    R, L = mm.shape
    ar = jnp.arange(L, dtype=jnp.int32)[None, :]
    inside = ar < read_len[:, None]
    w = jnp.where(inside, jnp.where(mm, -3, 1), 0).astype(jnp.int32)

    # S[b] = score of read[0:b]; window score [a,b) = S[b] - S[a]
    S = jnp.concatenate(
        [jnp.zeros((R, 1), jnp.int32), jnp.cumsum(w, axis=1)], axis=1
    )
    pm = jax.lax.cummin(S, axis=1)        # min_{a<=b} S[a]
    gain = S - pm                          # best window ending at b
    # b*: earliest argmax (padding past read_len contributes 0, so the
    # first maximal b sits at/before the read end → smallest right clip)
    b = jnp.argmax(gain, axis=1).astype(jnp.int32)
    minv = jnp.take_along_axis(pm, b[:, None], axis=1)[:, 0]
    # a*: earliest index achieving the prefix min → smallest left clip
    idx = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
    a = jnp.argmax((S == minv[:, None]) & (idx <= b[:, None]), axis=1)
    clip_left = a.astype(jnp.int32)
    clip_right = jnp.maximum(read_len - b, 0)
    # degenerate (empty best window: nothing worth keeping) → no clipping
    too_much = clip_left + clip_right >= read_len
    clip_left = jnp.where(too_much, 0, clip_left)
    clip_right = jnp.where(too_much, 0, clip_right)
    return clip_left.astype(jnp.int32), clip_right.astype(jnp.int32)
