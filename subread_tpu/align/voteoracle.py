"""Sequential oracle of the reference vote table (gehash_go_X).

A faithful pure-Python replay of `gehash_go_X` + `do_voting`'s two-round
driver (/root/reference/src/sorted-hashtable.c:937-1110, core.c:3149-3186):
the 30x24 vote table, first-match slot assignment over the iix row scan,
one-vote-per-subread with spill to the next matching slot, the section
back-off rule, the shift-indel mark + round-2 re-run with zero tolerance
at marked slots, and row-capacity drops.  Used by tests and diagnostics as
the ground truth the dense device kernel (ops.vote) must reproduce; too slow
for production (one read at a time).
"""

from __future__ import annotations

import numpy as np

TABLE_SIZE = 30     # GENE_VOTE_TABLE_SIZE (subread.h:216)
SPACE = 24          # GENE_VOTE_SPACE (subread.h:217)
SEG = 5             # INDEL_SEGMENT_SIZE
MAX_SECTIONS = 7    # MAX_INDEL_SECTIONS (subread.h:88)


class _Slot:
    __slots__ = ("pos", "strand", "votes", "toli", "recorder", "cursor",
                 "last_subread", "cov_start", "cov_end", "marked")

    def __init__(self, kv, strand, subread_p1, offset, marked):
        self.pos = kv
        self.strand = strand
        self.votes = 1
        self.toli = 0
        # flat triplets (start_subread, end_subread, dist), 1-based subreads
        self.recorder = [subread_p1, subread_p1, 0]
        self.cursor = 0
        self.last_subread = subread_p1
        self.cov_start = offset
        self.cov_end = offset + 16
        self.marked = marked


class VoteTable:
    def __init__(self):
        self.rows = [[] for _ in range(TABLE_SIZE)]
        self.max_vote = 0

    def _row(self, kv):
        return (kv // SEG) % TABLE_SIZE

    def go(self, occurrences, offset, strand, tolerance, subread_no,
           run_round, shift_locs, spill=True, backoff=True):
        """One probe's hits: `occurrences` = index positions of the key
        (ascending), offset = probe offset in the oriented read."""
        sp1 = subread_no + 1
        ii_end = SEG
        if tolerance > 5:
            ii_end = (tolerance - tolerance % SEG + SEG) \
                if tolerance % SEG else tolerance
        for pos in occurrences:
            kv = int(pos) - offset
            found = False
            iix = 0
            while iix <= ii_end:
                row = self.rows[self._row(kv + iix)]
                for slot in row:
                    dist0 = kv - slot.pos
                    tol = 0 if (run_round > 0 and slot.marked) else tolerance
                    if -tol <= dist0 <= tol and slot.strand == strand:
                        if (run_round == 0 and slot.toli > 0 and dist0 == 0
                                and not slot.marked):
                            slot.marked = True
                            shift_locs.append(slot.pos)
                        # back-off: same subread continuing, closer offset
                        if backoff and sp1 == slot.last_subread and slot.toli > 0:
                            toli = slot.toli
                            move = slot.recorder[toli - 3 + 2] if toli >= 3 else 0
                            new_dist = move - dist0
                            move -= slot.recorder[toli + 2]
                            if abs(move) > abs(new_dist):
                                slot.toli -= 3
                                slot.last_subread -= 1
                                slot.votes -= 1
                        if sp1 <= slot.last_subread:
                            if spill:
                                continue  # subread already voted: try next slot
                            found = True
                            break
                        slot.votes += 1
                        if offset + 16 > slot.cov_end:
                            slot.cov_end = offset + 16
                        toli = slot.toli
                        if dist0 == slot.cursor:
                            slot.recorder[toli + 1] = sp1
                        else:
                            toli += 3
                            if toli < MAX_SECTIONS * 3:
                                slot.toli = toli
                                while len(slot.recorder) < toli + 3:
                                    slot.recorder.append(0)
                                slot.recorder[toli:toli + 3] = [sp1, sp1, dist0]
                            slot.cursor = dist0
                        slot.last_subread = sp1
                        self.max_vote = max(self.max_vote, slot.votes)
                        found = True
                        break
                if found:
                    break
                iix = -iix if iix > 0 else (-iix + SEG)
            if not found:
                row = self.rows[self._row(kv)]
                if len(row) < SPACE:
                    marked = False
                    if run_round > 0:
                        for loc in shift_locs:
                            if loc - tolerance <= kv <= loc + tolerance:
                                marked = True
                                break
                    row.append(_Slot(kv, strand, sp1, offset, marked))


def revcomp_key(k: int) -> int:
    x = (~k) & 0xFFFFFFFF
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & 0xFFFFFFFF


def vote_read_oracle(index, codes: np.ndarray, read_len: int,
                     total_subreads: int, tolerance: int,
                     index_gap: int = 1, spill: bool = True,
                     backoff: bool = True, two_round: bool = True):
    """Replay the reference's per-read voting (both strands into ONE
    table, strand-major probe order as core.c:3110-3186 drives it:
    is_reversed outer, subreads inner).  Returns the list of slots.

    index: a HashIndex (canonical keys sorted, positions per run)."""
    ks = index.keys
    pos_arr = index.positions
    ori = index.orient

    def occ_of(key32: int, want_rev: bool):
        canon = min(key32, revcomp_key(key32))
        flipped = canon != key32
        lo = np.searchsorted(ks, np.uint32(canon), "left")
        hi = np.searchsorted(ks, np.uint32(canon), "right")
        if hi <= lo:
            return ()
        # stored orientation == probe flip -> genome kmer equals the probed
        # kmer exactly (forward match for this oriented read)
        sel = ori[lo:hi] == flipped
        return pos_arr[lo:hi][sel]

    # subread offsets (16.16 fixed-point, core.c:3115-3184)
    gap = index_gap
    step_fx = max(gap << 16,
                  ((read_len - 15 - gap) << 16) // max(total_subreads - 1, 1)
                  if total_subreads > 1 else 0)
    offsets = [(sn * step_fx) >> 16 for sn in range(total_subreads)]
    offsets = [min(o, max(read_len - 16, 0)) for o in offsets]

    rc = (3 - codes[::-1]).astype(np.uint8)

    def key_at(arr, o):
        k = 0
        for b in arr[o:o + 16]:
            k = ((k << 2) | int(b)) & 0xFFFFFFFF
        return k

    table = VoteTable()
    shift_locs: list[int] = []
    for run_round in (0, 1):
        table = VoteTable() if run_round or True else table
        if run_round == 0:
            shift_locs = []
        for strand in (0, 1):
            arr = codes if strand == 0 else rc
            for sn, o in enumerate(offsets):
                if gap > 1:
                    phases = range(gap)
                else:
                    phases = (0,)
                for ph in phases:
                    # reference snaps the nominal offset down to the gap
                    # grid before adding the phase (core.c:3169-3171)
                    ob = o - o % gap if gap > 1 else o
                    op = min(ob + ph, read_len - 16)
                    k = key_at(arr, op)
                    occ = occ_of(k, strand == 1)
                    table.go(occ, op, strand, tolerance, sn, run_round,
                             shift_locs, spill=spill, backoff=backoff)
        if run_round == 0 and (not shift_locs or not two_round):
            break
    slots = [s for row in table.rows for s in row]
    return slots
