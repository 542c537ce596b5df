"""Index sharding across chips — the space-parallel form of the
reference's index-block serialization.

The reference handles an index bigger than RAM by loading position-range
blocks one at a time and re-voting every read per block, accumulating one
vote table (read_chunk_circles, core.c:3562-3613).  On a mesh the same
decomposition goes over chips instead of over time: the genome's
(key, position) entries are split into contiguous POSITION ranges, one
shard per chip along the "index" mesh axis.  Position ranges (not key
ranges) keep every vote cluster — whose member probes are *different*
16-mers hitting the *same* locus — entirely inside one shard, so the
existing max-based partial-vote merge (ops.vote.merge_vote_results) is
exact; blocks overlap by the contig padding so reads straddling a cut
vote fully in both neighbours.

Layout: every shard is rebuilt with one SHARED bucket_bits (sized for the
largest shard) so a single jitted vote graph serves all shards, and the
per-shard comb_rows are padded to a common row count.  Each chip gathers
hits only from its own shard (1/S of the index in device memory — the reason to
shard), then partial top-K VoteResults are allgathered over the "index"
axis and folded left-to-right — the same fold order as the single-device
block loop in align.pipeline.Aligner, so results are bit-identical to it.

Composes with reads-axis data parallelism as a 2-D mesh
("reads" × "index"): reads are sharded over rows, the index over columns.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.build import HashIndex, native_layout, revcomp_keys_np
from ..ops.vote import VoteParams, VoteResult, merge_vote_results, vote_batch

READS_AXIS = "reads"
INDEX_AXIS = "index"


def make_mesh_2d(
    n_reads: int, n_index: int, devices=None
) -> Mesh:
    if devices is None:
        devices = jax.devices()
    devs = np.array(devices[: n_reads * n_index]).reshape(n_reads, n_index)
    return Mesh(devs, (READS_AXIS, INDEX_AXIS))


def split_index_shards(
    idx: HashIndex, n_shards: int, overlap: int | None = None
) -> list[HashIndex]:
    """Split an index into exactly n_shards position-range shards that all
    share one bucket_bits (the spatial analog of
    index.build.split_index_blocks)."""
    if n_shards <= 1:
        return [idx]
    n = idx.n_items
    overlap = idx.padding if overlap is None else overlap
    order = np.argsort(idx.positions, kind="stable")
    pos_sorted = idx.positions[order]
    genome_keys = np.where(idx.orient, revcomp_keys_np(idx.keys), idx.keys)
    per = -(-n // n_shards)
    # shared bucket space sized for the largest shard (per + overlap slack)
    bits = min(28, max(10, int(np.ceil(np.log2(max(per * 2, 2)))) + 2))
    shards = []
    for b in range(n_shards):
        lo, hi = b * per, min((b + 1) * per, n)
        if lo >= n:  # degenerate tiny index: empty trailing shard
            sel = np.zeros(n, bool)
        else:
            cut_lo = int(pos_sorted[lo])
            cut_hi = int(pos_sorted[hi - 1])
            sel = (idx.positions >= max(cut_lo - (overlap if b else 0), 0)) & (
                idx.positions <= cut_hi + (overlap if hi < n else 0)
            )
        shards.append(
            native_layout(
                genome_keys[sel], idx.positions[sel], idx.index_gap,
                idx.padding, bucket_bits=bits,
            )
        )
    return shards


def stack_shards(
    shards: list[HashIndex],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Stack shard arrays for device placement along the "index" axis:
    (bucket_start [S, B+1] int32, comb_rows [S, G, 24] uint32,
    sub_base [S, B] int32, sub_lo [S, M] int32, bucket_bits, sub_bits).
    comb_rows are padded to the largest shard's row count (padding rows are
    unreachable: bucket_start never points past a shard's own entries).
    Sub-bucket directories are rebuilt at one shared sub_bits (the max over
    shards — raising sub_bits keeps the run-start guarantee)."""
    bits = shards[0].bucket_bits
    assert all(s.bucket_bits == bits for s in shards)
    G = max(s.comb_rows.shape[0] for s in shards)
    bs = np.stack([s.bucket_start for s in shards])
    cb = np.stack(
        [
            np.pad(s.comb_rows, ((0, G - s.comb_rows.shape[0]), (0, 0)))
            for s in shards
        ]
    )
    from ..index.build import build_sub_directory

    dirs = [s.sub_dir for s in shards]
    sub_bits = max(d[2] for d in dirs)
    dirs = [
        d if d[2] == sub_bits or d[2] == 0
        else build_sub_directory(s.keys, s.orient, s.bucket_start, bits, force_bits=sub_bits)
        for s, d in zip(shards, dirs)
    ]
    M = max(len(d[1]) for d in dirs)
    sb = np.stack([d[0] for d in dirs])
    sl = np.stack([np.pad(d[1], (0, M - len(d[1]))) for d in dirs])
    assert all(d[3] == 0 for d in dirs)
    return bs, cb, sb, sl, bits, sub_bits


def place_sharded_index(mesh: Mesh, bs, cb, sb, sl):
    """Put the stacked shard arrays on the mesh: leading (shard) axis over
    the "index" mesh axis, replicated over "reads"."""
    put = lambda a: jax.device_put(
        a, NamedSharding(mesh, P(INDEX_AXIS, *([None] * (a.ndim - 1))))
    )
    return put(bs), put(cb), put(sb), put(sl)


def index_sharded_vote(
    mesh: Mesh, bucket_bits: int, params: VoteParams,
    static_len: int | None = None, sub_bits: int = 0,
):
    """Build a jitted vote step over a ("reads", "index") mesh.

    step(codes, ambig, lens, bs_stack, cb_stack, sb_stack, sl_stack) ->
    VoteResult replicated over the index axis, sharded over reads.  Each
    chip votes its reads against its index shard; the S partial top-K
    tables are allgathered over the mesh and folded with merge_vote_results
    (left-to-right, matching the single-device block loop so outputs are
    bit-identical)."""
    n_shards = mesh.shape[INDEX_AXIS]

    def local(codes, ambig, lens, bs, cb, sb, sl):
        v = vote_batch(
            codes, ambig, lens, bs[0], cb[0], bucket_bits, params,
            static_len=static_len, sub_base=sb[0], sub_lo=sl[0],
            sub_bits=sub_bits, search_steps=0,
        )
        if n_shards == 1:
            return v
        gathered = jax.lax.all_gather(v, INDEX_AXIS, axis=0)  # leaves [S, ...]
        acc = jax.tree.map(lambda a: a[0], gathered)
        for s in range(1, n_shards):
            acc = merge_vote_results(
                acc, jax.tree.map(lambda a: a[s], gathered), params
            )
        return acc

    read_spec = P(READS_AXIS, None)
    shard_spec = lambda nd: P(INDEX_AXIS, *([None] * (nd - 1)))
    mapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(read_spec, read_spec, P(READS_AXIS), shard_spec(2),
                  shard_spec(3), shard_spec(2), shard_spec(2)),
        out_specs=VoteResult(
            pos=read_spec, tail=read_spec, anchor=read_spec,
            votes=read_spec, strand=read_spec, cov_start=read_spec,
            cov_end=read_spec, probe_kv=P(READS_AXIS, None, None),
            saturated=P(READS_AXIS), apk=read_spec,
        ),
        check_vma=False,
    )
    return jax.jit(mapped)
