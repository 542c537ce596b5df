"""Typed configuration for the aligner family.

The reference spreads configuration over `configuration_t` (core.h:128-253)
with defaults in init_global_context (core-indel.c:4399-4530) and per-tool
overrides (SURVEY.md Appendix A.5).  Here one dataclass serves
subread-align / subjunc / subindel, specialised by constructors.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class AlignConfig:
    # seed-and-vote
    total_subreads: int = 10          # -n; 10 DNA / 14 RNA (core-indel.c:4473)
    min_votes: int = 3                # -m; min votes read 1 (3 DNA / 1 RNA)
    min_votes_second: int = 1         # -p; min votes read 2
    max_indel: int = 5                # -I
    max_mismatches: int = 3           # -M
    max_hits_per_probe: int = 16      # bucket-window width; key runs longer
    #                                   than this re-vote through the rescue
    #                                   tiers (results identical — verified
    #                                   bit-equal vs 32 on chr901 — but the
    #                                   narrow window halves the main vote
    #                                   sort/cluster stream)
    top_k: int = 4                    # candidate clusters kept per read

    # experiment
    is_rna_seq: bool = True           # -t 0=RNA 1=DNA (aligner requires -t)
    detect_junctions: bool = False    # subjunc: True (do_breakpoint_detection)
    all_junctions: bool = False       # --allJunctions (fusions too)

    # paired-end
    min_fragment: int = 50            # -d
    max_fragment: int = 600           # -D
    mate_orientation: str = "fr"      # -S

    # reporting
    multi_best: int = 1               # -B multi-mapping reports
    report_multi_mapping: bool = False  # --multiMapping; default = break-even
    #                                     reads reported unmapped (reference
    #                                     report_multi_mapping_reads=0,
    #                                     core-indel.c:4412)
    ignore_unmapped: bool = False     # --ignoreUnmapped: omit unmapped records
    min_mapped_length: int = 0        # --minMappedLength
    min_mapped_fraction: int = 0      # --minMappedFraction (subjunc, %)
    mapq_unique: int = 40             # MQS base (UsersGuide:580-592)
    show_soft_clipping: bool = True   # -J disables
    phred_offset: int = 33            # -P
    sam_output: bool = False          # --SAMoutput
    sort_by_coordinates: bool = False # --sortReadsByCoordinates (+BAI)
    rg_id: str | None = None
    rg_extra: tuple[str, ...] = ()

    # batching / chunking (device side; sizes tuned before the GPU port)
    batch_reads: int = 8192           # device batch (reference chunk = 20M)
    pad_read_len: int = 128           # static read-length bucket

    # scan-2 / realignment
    realign_band: int = 16            # banded DP half-width (core-indel.c:4573)
    dp_mismatch_tolerance: int = 2    # indel accepted if window mismatches <=2
    # banded-DP penalties (-X/-Y/-G/-E; core.h:248-251 DP_* defaults)
    dp_mismatch: int = 0              # -X DPMismatch
    dp_match: int = 2                 # -Y DPMatch
    dp_gap_open: int = -1             # -G DPGapOpen
    dp_gap_ext: int = 0               # -E DPGapExt


def aligner_config(**overrides) -> AlignConfig:
    """subread-align defaults (core-interface-aligner.c:12-90, A.5)."""
    cfg = AlignConfig(
        total_subreads=10, min_votes=3, min_votes_second=1,
        is_rna_seq=False, detect_junctions=False,
    )
    return replace(cfg, **overrides)


def subjunc_config(**overrides) -> AlignConfig:
    """subjunc defaults (core-interface-subjunc.c:252-280, A.5)."""
    cfg = AlignConfig(
        total_subreads=14, min_votes=1, min_votes_second=1,
        is_rna_seq=True, detect_junctions=True,
        # junction discovery wants more candidate clusters: 1-vote minor
        # halves must survive the top-K cut (measured +0.6% junction
        # recall over K=4 on the bundled junction reads; flat beyond 8)
        top_k=8,
    )
    return replace(cfg, **overrides)
