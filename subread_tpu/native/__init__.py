"""Native host layer: C++ hot loops for the output path.

Compiled lazily with g++ on first use; everything has a pure-Python
fallback so the package works without a toolchain.  `build_error()` says
why the library is missing when `get_lib()` returns None.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np

_HERE = pathlib.Path(__file__).parent
_LIB = None
_TRIED = False
_BUILD_ERROR: str | None = None


def _build() -> pathlib.Path | None:
    global _BUILD_ERROR
    srcs = [
        _HERE / "samtext.cpp", _HERE / "fccount.cpp", _HERE / "pack.cpp",
        _HERE / "bgzf.cpp", _HERE / "snppile.cpp", _HERE / "dpalign.cpp",
    ]
    out = _HERE / "libsamtext.so"
    if out.exists() and all(
        out.stat().st_mtime >= s.stat().st_mtime for s in srcs
    ):
        return out
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-o", str(out)]
            + [str(s) for s in srcs] + ["-lz"],
            check=True, capture_output=True, text=True, timeout=120,
        )
        return out
    except Exception as e:  # no toolchain / failed build → fallback
        _BUILD_ERROR = f"{e}\n{getattr(e, 'stderr', '') or ''}".strip()
        print(f"// native build skipped: {e}", file=sys.stderr)
        return None


def build_error() -> str | None:
    """Why the last build failed (g++'s own message included), or None."""
    return _BUILD_ERROR


def get_lib():
    """ctypes handle to the native library, or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.format_sam_records.restype = ctypes.c_long
    lib.fc_count_sam_simple.restype = ctypes.c_long
    lib.fc_count_bam_simple.restype = ctypes.c_long
    lib.pack_reads_2bit.restype = ctypes.c_long
    lib.bgzf_total_isize.restype = ctypes.c_long
    lib.bgzf_inflate_all.restype = ctypes.c_long
    lib.snp_pileup_bam.restype = ctypes.c_long
    lib.dp_align_batch.restype = ctypes.c_long
    lib.dp_events_batch.restype = ctypes.c_long
    lib.fc_count_sam_pe.restype = ctypes.c_long
    lib.fc_count_bam_pe.restype = ctypes.c_long
    lib.fc_bam_split_offsets.restype = ctypes.c_long
    lib.fc_read_sections_sam.restype = ctypes.c_long
    lib.fc_read_sections_bam.restype = ctypes.c_long
    _LIB = lib
    return _LIB


def format_sam_records(
    names: list[str],
    codes: np.ndarray, quals: np.ndarray, lens: np.ndarray,
    flags: np.ndarray, cidx: np.ndarray, pos1: np.ndarray,
    mapqs: np.ndarray, indel: np.ndarray, split: np.ndarray,
    junc_gap: np.ndarray | None,
    clip_l: np.ndarray | None, clip_r: np.ndarray | None,
    mapped: np.ndarray, nm: np.ndarray,
    contig_names: list[str],
    suppress: np.ndarray | None = None,
    rnext_cidx: np.ndarray | None = None,   # -1 = "*", -2 = "="
    pnext: np.ndarray | None = None,
    tlen: np.ndarray | None = None,
    hi: np.ndarray | None = None,           # HI:i tag values
    nh: np.ndarray | None = None,           # NH:i values; 0 = no HI/NH tags
) -> bytes | None:
    """Format a batch of SAM records natively; None → caller falls back."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(names)
    name_blob = "".join(names).encode()
    name_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s.encode()) for s in names], out=name_off[1:])
    contig_blob = "".join(contig_names).encode()
    contig_off = np.zeros(len(contig_names) + 1, dtype=np.int64)
    np.cumsum([len(s.encode()) for s in contig_names], out=contig_off[1:])

    Lmax = codes.shape[1]
    cap = int(n * (2 * Lmax + 256) + name_blob.__sizeof__() + 4096)
    out = ctypes.create_string_buffer(cap)

    c = lambda a, t: np.ascontiguousarray(a, dtype=t)
    a_codes = c(codes, np.uint8)
    a_quals = c(quals, np.uint8)
    arrs = dict(
        lens=c(lens, np.int32), flags=c(flags, np.int32),
        cidx=c(cidx, np.int32), pos1=c(pos1, np.int32),
        mapqs=c(mapqs, np.int32), indel=c(indel, np.int32),
        split=c(split, np.int32),
        junc=c(junc_gap if junc_gap is not None else np.zeros(n), np.int32),
        clip_l=c(clip_l if clip_l is not None else np.zeros(n), np.int32),
        clip_r=c(clip_r if clip_r is not None else np.zeros(n), np.int32),
        mapped=c(mapped, np.uint8), nm=c(nm, np.int32),
    )
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    sup = (
        np.ascontiguousarray(suppress, np.uint8)
        if suppress is not None else None
    )
    pe = rnext_cidx is not None
    if pe:
        arrs["rnext"] = c(rnext_cidx, np.int32)
        arrs["pnext"] = c(pnext, np.int32)
        arrs["tlen"] = c(tlen, np.int32)
    tags = hi is not None and nh is not None
    if tags:
        arrs["hi"] = c(hi, np.int32)
        arrs["nh"] = c(nh, np.int32)
    written = lib.format_sam_records(
        ctypes.c_int32(n),
        ctypes.c_char_p(name_blob), ptr(name_off),
        ptr(a_codes), ptr(a_quals), ptr(arrs["lens"]), ctypes.c_int32(Lmax),
        ptr(arrs["flags"]), ptr(arrs["cidx"]), ptr(arrs["pos1"]),
        ptr(arrs["mapqs"]), ptr(arrs["indel"]), ptr(arrs["split"]),
        ptr(arrs["junc"]), ptr(arrs["clip_l"]), ptr(arrs["clip_r"]),
        ptr(arrs["mapped"]), ptr(arrs["nm"]),
        ctypes.c_char_p(contig_blob), ptr(contig_off),
        ptr(sup) if sup is not None else None,
        ptr(arrs["rnext"]) if pe else None,
        ptr(arrs["pnext"]) if pe else None,
        ptr(arrs["tlen"]) if pe else None,
        ptr(arrs["hi"]) if tags else None,
        ptr(arrs["nh"]) if tags else None,
        out, ctypes.c_int64(cap),
    )
    if written < 0:
        return None
    return out.raw[:written]


# featureCounts fast-path summary slot order (fccount.cpp enum)
FC_SUMMARY_SLOTS = [
    "Assigned", "Unassigned_Unmapped", "Unassigned_NoFeatures",
    "Unassigned_Ambiguity", "Unassigned_MultiMapping",
    "Unassigned_MappingQuality", "Unassigned_Duplicate",
]


def fc_count_sam_simple(
    sam_bytes: bytes,
    chrom_names: list[str],
    feat_start: np.ndarray, feat_end: np.ndarray,
    feat_pmax_end: np.ndarray, feat_target: np.ndarray,
    feat_strand: np.ndarray, chrom_feat_off: np.ndarray,
    n_targets: int,
    min_mapq: int, primary_only: bool, ignore_dup: bool,
    count_multi: bool, strandness: int, max_mop: int,
    start: int = 0, length: int | None = None,
):
    """Native single-end featureCounts pass.  Returns (counts, summary
    dict, n_records) or None when unavailable / the file needs the full
    python engine.  start/length window into sam_bytes without a slice
    copy, so line-aligned ranges can count in parallel threads (the C
    call releases the GIL)."""
    lib = get_lib()
    if lib is None:
        return None
    blob = "".join(chrom_names).encode()
    off = np.zeros(len(chrom_names) + 1, np.int64)
    np.cumsum([len(c.encode()) for c in chrom_names], out=off[1:])
    counts = np.zeros(n_targets, np.float64)
    summary = np.zeros(len(FC_SUMMARY_SLOTS), np.int64)
    c = lambda a, t: np.ascontiguousarray(a, dtype=t)
    arrs = dict(
        fs=c(feat_start, np.int32), fe=c(feat_end, np.int32),
        pm=c(feat_pmax_end, np.int32), tg=c(feat_target, np.int64),
        st=c(feat_strand, np.int8), co=c(chrom_feat_off, np.int64),
    )
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    if length is None:
        length = len(sam_bytes) - start
    base = ctypes.cast(ctypes.c_char_p(sam_bytes), ctypes.c_void_p).value
    rv = lib.fc_count_sam_simple(
        ctypes.c_void_p(base + start), ctypes.c_long(length),
        ctypes.c_char_p(blob), ptr(off), ctypes.c_int32(len(chrom_names)),
        ptr(arrs["fs"]), ptr(arrs["fe"]), ptr(arrs["pm"]), ptr(arrs["tg"]),
        ptr(arrs["st"]), ptr(arrs["co"]), ctypes.c_int64(n_targets),
        ctypes.c_int32(min_mapq), ctypes.c_int32(int(primary_only)),
        ctypes.c_int32(int(ignore_dup)), ctypes.c_int32(int(count_multi)),
        ctypes.c_int32(strandness), ctypes.c_int32(max_mop),
        ptr(counts), ptr(summary),
    )
    if rv < 0:
        return None
    return counts, dict(zip(FC_SUMMARY_SLOTS, summary.tolist())), int(rv)


def fc_count_bam_simple(
    bam_records: bytes,          # uncompressed BAM stream (records at `start`)
    ref2chrom: np.ndarray,       # int32 [n_refs] BAM ref id -> chrom table id
    feat_start: np.ndarray, feat_end: np.ndarray,
    feat_pmax_end: np.ndarray, feat_target: np.ndarray,
    feat_strand: np.ndarray, chrom_feat_off: np.ndarray,
    n_targets: int,
    min_mapq: int, primary_only: bool, ignore_dup: bool,
    count_multi: bool, strandness: int, max_mop: int,
    start: int = 0, length: int | None = None,
):
    """Native single-end featureCounts pass over BAM records.

    `start`/`length` window into bam_records without slicing (a [208MB
    stream] slice copy measured ~0.2s per call); record-aligned windows
    from fc_bam_split_offsets let ranges count in parallel threads."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.zeros(n_targets, np.float64)
    summary = np.zeros(len(FC_SUMMARY_SLOTS), np.int64)
    c = lambda a, t: np.ascontiguousarray(a, dtype=t)
    arrs = dict(
        r2c=c(ref2chrom, np.int32),
        fs=c(feat_start, np.int32), fe=c(feat_end, np.int32),
        pm=c(feat_pmax_end, np.int32), tg=c(feat_target, np.int64),
        st=c(feat_strand, np.int8), co=c(chrom_feat_off, np.int64),
    )
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    base = ctypes.cast(ctypes.c_char_p(bam_records), ctypes.c_void_p).value
    if length is None:
        length = len(bam_records) - start
    rv = lib.fc_count_bam_simple(
        ctypes.c_void_p(base + start),
        ctypes.c_long(length),
        ptr(arrs["r2c"]), ctypes.c_int32(len(ref2chrom)),
        ptr(arrs["fs"]), ptr(arrs["fe"]), ptr(arrs["pm"]), ptr(arrs["tg"]),
        ptr(arrs["st"]), ptr(arrs["co"]), ctypes.c_int64(n_targets),
        ctypes.c_int32(min_mapq), ctypes.c_int32(int(primary_only)),
        ctypes.c_int32(int(ignore_dup)), ctypes.c_int32(int(count_multi)),
        ctypes.c_int32(strandness), ctypes.c_int32(max_mop),
        ptr(counts), ptr(summary),
    )
    if rv < 0:
        return None
    return counts, dict(zip(FC_SUMMARY_SLOTS, summary.tolist())), int(rv)


def fc_bam_split_offsets(bam_records: bytes, start: int, n_parts: int):
    """Record-aligned byte offsets splitting [start:] into ~n_parts ranges
    (relative to `start`); None when unavailable/malformed."""
    lib = get_lib()
    if lib is None:
        return None
    cuts = np.zeros(max(n_parts, 2), np.int64)
    base = ctypes.cast(ctypes.c_char_p(bam_records), ctypes.c_void_p).value
    n = lib.fc_bam_split_offsets(
        ctypes.c_void_p(base + start),
        ctypes.c_long(len(bam_records) - start),
        ctypes.c_int32(n_parts),
        cuts.ctypes.data_as(ctypes.c_void_p),
    )
    if n < 0:
        return None
    return cuts[:n].tolist()


def fc_count_sam_pe(
    sam_bytes: bytes,
    chrom_names: list[str],
    feat_start: np.ndarray, feat_end: np.ndarray,
    feat_pmax_end: np.ndarray, feat_target: np.ndarray,
    feat_strand: np.ndarray, chrom_feat_off: np.ndarray,
    n_targets: int,
    min_mapq: int, primary_only: bool, ignore_dup: bool,
    count_multi: bool, strandness: int, max_mop: int,
):
    """Native paired-end featureCounts pass (fragment counting with qname
    mate re-pairing).  Same return contract as fc_count_sam_simple."""
    lib = get_lib()
    if lib is None:
        return None
    blob = "".join(chrom_names).encode()
    off = np.zeros(len(chrom_names) + 1, np.int64)
    np.cumsum([len(c.encode()) for c in chrom_names], out=off[1:])
    counts = np.zeros(n_targets, np.float64)
    summary = np.zeros(len(FC_SUMMARY_SLOTS), np.int64)
    c = lambda a, t: np.ascontiguousarray(a, dtype=t)
    arrs = dict(
        fs=c(feat_start, np.int32), fe=c(feat_end, np.int32),
        pm=c(feat_pmax_end, np.int32), tg=c(feat_target, np.int64),
        st=c(feat_strand, np.int8), co=c(chrom_feat_off, np.int64),
    )
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    rv = lib.fc_count_sam_pe(
        ctypes.c_char_p(sam_bytes), ctypes.c_long(len(sam_bytes)),
        ctypes.c_char_p(blob), ptr(off), ctypes.c_int32(len(chrom_names)),
        ptr(arrs["fs"]), ptr(arrs["fe"]), ptr(arrs["pm"]), ptr(arrs["tg"]),
        ptr(arrs["st"]), ptr(arrs["co"]), ctypes.c_int64(n_targets),
        ctypes.c_int32(min_mapq), ctypes.c_int32(int(primary_only)),
        ctypes.c_int32(int(ignore_dup)), ctypes.c_int32(int(count_multi)),
        ctypes.c_int32(strandness), ctypes.c_int32(max_mop),
        ptr(counts), ptr(summary),
    )
    if rv < 0:
        return None
    return counts, dict(zip(FC_SUMMARY_SLOTS, summary.tolist())), int(rv)


def fc_count_bam_pe(
    bam_records: bytes,
    ref2chrom: np.ndarray,
    feat_start: np.ndarray, feat_end: np.ndarray,
    feat_pmax_end: np.ndarray, feat_target: np.ndarray,
    feat_strand: np.ndarray, chrom_feat_off: np.ndarray,
    n_targets: int,
    min_mapq: int, primary_only: bool, ignore_dup: bool,
    count_multi: bool, strandness: int, max_mop: int,
    start: int = 0,
):
    """Native paired-end featureCounts pass over BAM records."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.zeros(n_targets, np.float64)
    summary = np.zeros(len(FC_SUMMARY_SLOTS), np.int64)
    c = lambda a, t: np.ascontiguousarray(a, dtype=t)
    arrs = dict(
        r2c=c(ref2chrom, np.int32),
        fs=c(feat_start, np.int32), fe=c(feat_end, np.int32),
        pm=c(feat_pmax_end, np.int32), tg=c(feat_target, np.int64),
        st=c(feat_strand, np.int8), co=c(chrom_feat_off, np.int64),
    )
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    base = ctypes.cast(ctypes.c_char_p(bam_records), ctypes.c_void_p).value
    rv = lib.fc_count_bam_pe(
        ctypes.c_void_p(base + start),
        ctypes.c_long(len(bam_records) - start),
        ptr(arrs["r2c"]), ctypes.c_int32(len(ref2chrom)),
        ptr(arrs["fs"]), ptr(arrs["fe"]), ptr(arrs["pm"]), ptr(arrs["tg"]),
        ptr(arrs["st"]), ptr(arrs["co"]), ctypes.c_int64(n_targets),
        ctypes.c_int32(min_mapq), ctypes.c_int32(int(primary_only)),
        ctypes.c_int32(int(ignore_dup)), ctypes.c_int32(int(count_multi)),
        ctypes.c_int32(strandness), ctypes.c_int32(max_mop),
        ptr(counts), ptr(summary),
    )
    if rv < 0:
        return None
    return counts, dict(zip(FC_SUMMARY_SLOTS, summary.tolist())), int(rv)


def bgzf_inflate(raw: bytes, threads: int = 0) -> bytes | None:
    """Parallel whole-stream BGZF inflate (bgzf.cpp); None when the native
    library is unavailable or the stream is malformed (caller falls back
    to the Python block loop)."""
    lib = get_lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    total = lib.bgzf_total_isize(ctypes.c_char_p(raw), ctypes.c_long(len(raw)))
    if total < 0:
        return None
    # Allocate uninitialized bytes and let the C++ pool write straight into
    # it (the C-extension pattern: PyBytes_FromStringAndSize(NULL, n) then
    # fill while refcount==1).  Avoids both create_string_buffer's zero-fill
    # and a tobytes copy — each measured ~0.2-0.6s on a 208MB stream.
    api = ctypes.pythonapi
    api.PyBytes_FromStringAndSize.restype = ctypes.py_object
    api.PyBytes_FromStringAndSize.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
    out = api.PyBytes_FromStringAndSize(None, total)
    dst = ctypes.cast(ctypes.c_char_p(out), ctypes.c_void_p)
    rv = lib.bgzf_inflate_all(
        ctypes.c_char_p(raw), ctypes.c_long(len(raw)),
        dst, ctypes.c_long(total), ctypes.c_int32(threads),
    )
    if rv != total:
        return None
    return out


def snp_pileup_bam(
    bam_records: bytes, start: int,
    ref2chrom: np.ndarray,        # int32 [n_refs] -> chrom id or -1
    chrom_off: np.ndarray,        # int64 [n_chroms] position offsets in votes
    chrom_len: np.ndarray,        # int64 [n_chroms]
    votes: np.ndarray,            # int32 [total_positions, 4], accumulated into
    trim: int, min_q: int, qual_bias: int,
):
    """Native exactSNP pileup (snppile.cpp).  Returns
    (n_records, indels list of (chrom, pos0, length, seq, count)) or None."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    base = ctypes.cast(ctypes.c_char_p(bam_records), ctypes.c_void_p).value
    r2c = np.ascontiguousarray(ref2chrom, np.int32)
    coff = np.ascontiguousarray(chrom_off, np.int64)
    clen = np.ascontiguousarray(chrom_len, np.int64)
    assert votes.dtype == np.int32 and votes.flags.c_contiguous
    # accumulate into a scratch buffer: the C call votes BEFORE serializing
    # indels, so a capacity retry must not double-count into the caller's
    tmp = np.zeros_like(votes)
    cap = 1 << 16
    blob_cap = 1 << 20
    while True:
        o_chrom = np.empty(cap, np.int32)
        o_pos = np.empty(cap, np.int64)
        o_len = np.empty(cap, np.int32)
        o_cnt = np.empty(cap, np.int64)
        o_soff = np.empty(cap, np.int64)
        o_blob = np.empty(blob_cap, np.uint8)
        n_ind = ctypes.c_long(0)
        blob_len = ctypes.c_long(0)
        rv = lib.snp_pileup_bam(
            ctypes.c_void_p(base + start),
            ctypes.c_long(len(bam_records) - start),
            ptr(r2c), ctypes.c_int32(len(r2c)),
            ptr(coff), ptr(clen), ctypes.c_int32(len(coff)),
            ctypes.c_int32(trim), ctypes.c_int32(min_q),
            ctypes.c_int32(qual_bias),
            ptr(tmp),
            ptr(o_chrom), ptr(o_pos), ptr(o_len), ptr(o_cnt), ptr(o_soff),
            ctypes.c_long(cap), ptr(o_blob), ctypes.c_long(blob_cap),
            ctypes.byref(n_ind), ctypes.byref(blob_len),
        )
        if rv == -2:
            cap *= 4
            blob_cap *= 4
            tmp[:] = 0
            continue
        if rv < 0:
            return None
        votes += tmp
        ind = []
        blob = o_blob.tobytes()
        for i in range(n_ind.value):
            so = int(o_soff[i])
            sl = -int(o_len[i]) if o_len[i] < 0 else 0
            ind.append((
                int(o_chrom[i]), int(o_pos[i]), int(o_len[i]),
                blob[so : so + sl].decode(), int(o_cnt[i]),
            ))
        return int(rv), ind


def pack_reads_2bit(codes: np.ndarray, ambig: np.ndarray | None):
    """Native 2-bit read packing (dna.pack_reads_host layout); returns
    (words, amask-or-None) or None when the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    R, L = codes.shape
    W = (L + 15) // 16
    A = (L + 31) // 32
    codes = np.ascontiguousarray(codes, np.uint8)
    words = np.empty((R, W), np.uint32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    if ambig is not None:
        ambig_c = np.ascontiguousarray(ambig, np.uint8)
        amask = np.empty((R, A), np.uint32)
        lib.pack_reads_2bit(
            ptr(codes), ctypes.c_int64(R), ctypes.c_int64(L),
            ptr(words), ctypes.c_int64(W),
            ptr(ambig_c), ptr(amask), ctypes.c_int64(A),
        )
        return words, amask
    lib.pack_reads_2bit(
        ptr(codes), ctypes.c_int64(R), ctypes.c_int64(L),
        ptr(words), ctypes.c_int64(W),
        None, None, ctypes.c_int64(A),
    )
    return words, None


def _chrom_blob(chrom_names: list[str]):
    blob = "".join(chrom_names).encode()
    off = np.zeros(len(chrom_names) + 1, np.int64)
    np.cumsum([len(n.encode()) for n in chrom_names], out=off[1:])
    return blob, off


def fc_read_sections_sam(sam_bytes: bytes, chrom_names: list[str],
                         S: int, max_mop: int = 10):
    """Per-record section extraction for the device counter: returns
    (chrom_idx, nsec, sec_s[R,S], sec_e[R,S] local 1-based, flag, nh,
    qname_hash) numpy arrays, or None when the native lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    blob, off = _chrom_blob(chrom_names)
    cap = max(sam_bytes.count(b"\n") + 16, 1024)
    while True:
        chrom_idx = np.zeros(cap, np.int32)
        nsec = np.zeros(cap, np.int32)
        sec_s = np.zeros((cap, S), np.int32)
        sec_e = np.zeros((cap, S), np.int32)
        flag = np.zeros(cap, np.int32)
        nh = np.zeros(cap, np.int32)
        qh = np.zeros(cap, np.int64)
        n = lib.fc_read_sections_sam(
            sam_bytes, ctypes.c_long(len(sam_bytes)),
            blob, off.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int32(len(chrom_names)),
            ctypes.c_int32(S), ctypes.c_int32(max_mop),
            chrom_idx.ctypes.data_as(ctypes.c_void_p),
            nsec.ctypes.data_as(ctypes.c_void_p),
            sec_s.ctypes.data_as(ctypes.c_void_p),
            sec_e.ctypes.data_as(ctypes.c_void_p),
            flag.ctypes.data_as(ctypes.c_void_p),
            nh.ctypes.data_as(ctypes.c_void_p),
            qh.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(cap),
        )
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            return None
        return (chrom_idx[:n], nsec[:n], sec_s[:n], sec_e[:n],
                flag[:n], nh[:n], qh[:n])


def fc_read_sections_bam(bam_records: bytes, ref2chrom: np.ndarray,
                         S: int, max_mop: int = 10, start: int = 0):
    """BAM variant of fc_read_sections_sam over decompressed records."""
    lib = get_lib()
    if lib is None:
        return None
    ref2chrom = np.ascontiguousarray(ref2chrom, np.int32)
    base = ctypes.cast(ctypes.c_char_p(bam_records), ctypes.c_void_p).value
    cap = max(len(bam_records) // 64, 1024)
    while True:
        chrom_idx = np.zeros(cap, np.int32)
        nsec = np.zeros(cap, np.int32)
        sec_s = np.zeros((cap, S), np.int32)
        sec_e = np.zeros((cap, S), np.int32)
        flag = np.zeros(cap, np.int32)
        nh = np.zeros(cap, np.int32)
        qh = np.zeros(cap, np.int64)
        n = lib.fc_read_sections_bam(
            ctypes.c_void_p(base + start),
            ctypes.c_long(len(bam_records) - start),
            ref2chrom.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int32(len(ref2chrom)),
            ctypes.c_int32(S), ctypes.c_int32(max_mop),
            chrom_idx.ctypes.data_as(ctypes.c_void_p),
            nsec.ctypes.data_as(ctypes.c_void_p),
            sec_s.ctypes.data_as(ctypes.c_void_p),
            sec_e.ctypes.data_as(ctypes.c_void_p),
            flag.ctypes.data_as(ctypes.c_void_p),
            nh.ctypes.data_as(ctypes.c_void_p),
            qh.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(cap),
        )
        if n == -2:
            cap *= 2
            continue
        if n < 0:
            return None
        return (chrom_idx[:n], nsec[:n], sec_s[:n], sec_e[:n],
                flag[:n], nh[:n], qh[:n])
