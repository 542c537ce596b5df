"""Base encodings and 2-bit packing, numpy host-side.

Encoding follows the reference index interchange convention
(`base2int`, reference subread.h:238): A=0, G=1, C=2, T=3.  Any other
letter maps the same way the reference macro does (everything < 'G'
and != 'A' → 2, everything >= 'G' and != 'G' → 3; so N → 3).  Reads
additionally track an N/ambiguity mask so voting can skip probes that
contain N (the reference skips such 16-mers via its `skips` counter,
index-builder.c:229-234).

A nice property of this code: complement(c) == 3 - c.
"""

from __future__ import annotations

import numpy as np

A, G, C, T = 0, 1, 2, 3

# --- LUTs ------------------------------------------------------------------

# base2int-compatible LUT over all 256 byte values.
BASE2CODE = np.zeros(256, dtype=np.uint8)
for _b in range(256):
    _c = chr(_b).upper()
    if _c == "A":
        BASE2CODE[_b] = A
    elif _c == "G":
        BASE2CODE[_b] = G
    elif _c < "G":
        BASE2CODE[_b] = C
    else:
        BASE2CODE[_b] = T

CODE2BASE = np.frombuffer(b"AGCT", dtype=np.uint8)

# Genome-path LUT: the reference index builder's FASTA sanity pass rewrites
# every non-ACGT character (including N, '.', '-') to 'A'
# (check_and_convert_FastA, index-builder.c:789+).
GENOME2CODE = np.zeros(256, dtype=np.uint8)  # default 'A' = 0
for _b, _code in zip(b"AGCTagct", [0, 1, 2, 3, 0, 1, 2, 3]):
    GENOME2CODE[_b] = _code


# True at 'N'/'n' only: the reference skips ONLY literal N in its 16-mer
# scans (index-builder.c:229 `if (nch == 'N') skips = 16`); other junk
# letters (IUPAC codes etc.) map through base2int like normal bases.
AMBIG = np.zeros(256, dtype=bool)
AMBIG[ord("N")] = True
AMBIG[ord("n")] = True


def encode_genome(seq: bytes | str) -> np.ndarray:
    """Genome FASTA encoding: non-ACGT (incl. N) -> A, like the reference's
    index-builder FASTA rewrite."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return GENOME2CODE[raw]


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence → uint8 codes (A=0,G=1,C=2,T=3; N→3 like the ref)."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return BASE2CODE[raw]


def ambig_mask(seq: bytes | str) -> np.ndarray:
    """ASCII sequence → bool mask, True at non-ACGT letters (N etc.)."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return AMBIG[raw]


def decode(codes: np.ndarray) -> str:
    return CODE2BASE[np.asarray(codes, dtype=np.uint8) & 3].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (complement = 3 - code)."""
    return (3 - codes[..., ::-1]).astype(codes.dtype)


# --- 2-bit packing ---------------------------------------------------------
# Layout matches the reference on-disk `.array` format (gene-value-index.c:43):
# base i occupies bits (i%4)*2 within byte i//4 — i.e. LSB-first.  Interpreting
# 4 consecutive bytes as a little-endian uint32 puts base i at bits (i%16)*2.


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes → packed uint8 array, 4 bases per byte, LSB-first."""
    n = len(codes)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    quads = codes.reshape(-1, 4).astype(np.uint8)
    return (
        quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4) | (quads[:, 3] << 6)
    ).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    """Packed uint8 array → uint8 codes of length n."""
    b = np.asarray(packed, dtype=np.uint8)
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = b & 3
    out[1::4] = (b >> 2) & 3
    out[2::4] = (b >> 4) & 3
    out[3::4] = (b >> 6) & 3
    return out[:n]


def packed_as_u32(packed: np.ndarray) -> np.ndarray:
    """Packed bytes → little-endian uint32 words (16 bases/word) for device."""
    b = np.asarray(packed, dtype=np.uint8)
    pad = (-len(b)) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
    return b.view("<u4")


# --- 16-mer keys -----------------------------------------------------------
# Key packing is big-endian-first: base 0 at bits 30-31 (`genekey2int`,
# reference input-files.c:1232).

# SOLiD color-space decode (-b/--color-convert; reference colorread2base,
# input-files.c:1271-1307).  Color c maps previous base -> next base:
# 0 same, 1 A<->C/G<->T, 2 A<->G/C<->T, 3 A<->T/C<->G.  The primer base at
# position 0 is kept, mirroring the reference's in-place conversion.
_CS_NEXT = {
    b"A"[0]: b"ACGT", b"C"[0]: b"CATG", b"G"[0]: b"GTAC", b"T"[0]: b"TGCA",
}


def colorspace_decode(seq: bytes) -> bytes:
    if not seq:
        return seq
    out = bytearray(seq)
    last = out[0]
    if last not in _CS_NEXT:  # not color-space after all
        return seq
    for i in range(1, len(out)):
        d = out[i] - 0x30  # '0'..'3'
        if 0 <= d <= 3:
            last = _CS_NEXT[last][d]
        else:  # '.' / 'N' color: emit N, restart from A
            last = b"N"[0]
        out[i] = last
        if last == b"N"[0]:
            last = b"A"[0]
    return bytes(out)


KMER = 16


def kmer_keys(codes: np.ndarray) -> np.ndarray:
    """All overlapping 16-mer keys of a code array.

    Returns uint32 array of length max(0, len(codes)-15); keys[i] is the
    big-endian-packed 16-mer starting at i.
    """
    n = len(codes)
    if n < KMER:
        return np.zeros(0, dtype=np.uint32)
    # two-level packing: 4 bases -> one byte (uint8 passes), then 4 bytes
    # -> one uint32 key.  8 cheap vector passes instead of 16 uint64 ones
    # (measured ~3x at 100M bases).
    m = n - KMER + 1
    c = codes & 3
    b = (c[0 : m + 12].astype(np.uint8) << 6)
    b |= c[1 : m + 13] << 4
    b |= c[2 : m + 14] << 2
    b |= c[3 : m + 15]
    out = b[0:m].astype(np.uint32) << 24
    out |= b[4 : m + 4].astype(np.uint32) << 16
    out |= b[8 : m + 8].astype(np.uint32) << 8
    out |= b[12 : m + 12]
    return out


def window_has_ambig(ambig: np.ndarray, k: int = KMER) -> np.ndarray:
    """Sliding-window any() of an ambiguity mask: True where the k-window
    starting at i contains an ambiguous base."""
    n = len(ambig)
    if n < k:
        return np.zeros(0, dtype=bool)
    cs = np.concatenate([[0], np.cumsum(ambig.astype(np.int32))])
    return (cs[k:] - cs[:-k]) > 0


def pack_reads_host(codes: np.ndarray, ambig: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a read batch for device upload: 2-bit codes into uint32 words
    (base j of a row at bits 2*(j%16) of word j//16) plus an ambiguity
    bitmask (base j at bit j%32 of word j//32).

    Packing shrinks the upload 5x against [R, L] uint8 codes + bool
    ambig, and the device-side unpack is elementwise shifts.  Whether the
    packing still pays over PCIe is not measured yet.

    Tries the native C++ packer first (~10x the numpy ladder below)."""
    R, L = codes.shape
    W = (L + 15) // 16
    A = (L + 31) // 32
    if ambig is not None and not ambig.any():
        ambig = None  # the bit-packing of an all-zero mask is the slow part
    try:
        from . import native

        out = native.pack_reads_2bit(codes, ambig)
    except Exception:
        out = None
    if out is not None:
        words, amask = out
        if amask is None:
            amask = np.zeros((R, A), np.uint32)
        return words, amask
    if ambig is None:
        ambig = np.zeros((R, L), bool)
    # log-ladder packing (3 shrinking uint8 passes + LE uint32 view):
    # base j lands at bits 8*((j%16)//4) + 2*(j%4) of word j//16, which
    # equals bits 2*(j%16) — the layout unpack_reads_device expects.
    c = np.zeros((R, W * 16), np.uint8)
    c[:, :L] = codes
    c2 = c[:, 0::2] | (c[:, 1::2] << 2)
    c4 = c2[:, 0::2] | (c2[:, 1::2] << 4)
    words = np.ascontiguousarray(c4).view(np.uint32)
    a = np.zeros((R, A * 32), np.uint8)
    a[:, :L] = ambig
    a1 = a[:, 0::2] | (a[:, 1::2] << 1)
    a2 = a1[:, 0::2] | (a1[:, 1::2] << 2)
    a4 = a2[:, 0::2] | (a2[:, 1::2] << 4)
    amask = np.ascontiguousarray(a4).view(np.uint32)
    return words, amask


def unpack_reads_device(words, amask, L: int):
    """Device-side inverse of pack_reads_host: (codes uint8 [R, L],
    ambig bool [R, L]); everything elementwise (no gathers).  amask=None
    means the batch has no ambiguous bases (the mask upload is skipped)
    and ambig comes back all-False."""
    import jax.numpy as jnp

    R, W = words.shape
    sh = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = ((words[:, :, None] >> sh) & 3).reshape(R, W * 16)[:, :L]
    if amask is None:
        ambig = jnp.zeros((R, L), bool)
    else:
        A = amask.shape[1]
        sha = np.arange(32, dtype=np.uint32)[None, None, :]
        ambig = ((amask[:, :, None] >> sha) & 1).reshape(R, A * 32)[:, :L]
    return codes.astype(jnp.uint8), ambig != 0
