"""Multi-process orchestration (the reference has no distributed
backend — SURVEY.md §2 mandates one).

Design: `jax.distributed.initialize` connects the processes, one process
per card; a global 1-D "reads" mesh spans every card of every process.
Each process streams its own FASTQ shard (round-robin by read index so
load balances regardless of file layout), feeds its card, and the small
result statistics / event tables ride `psum` collectives.  Ordered
output: each process writes `<out>.part-<proc>` and rank 0 concatenates
(the analog of the reference's output_lock ordering, core.c:2383).

Everything here also runs single-process (the common case and the test
path): `init_distributed()` is a no-op when no coordinator is configured.
"""

from __future__ import annotations

import os

import numpy as np


def local_card(env=os.environ) -> list[int] | None:
    """The one card this process keeps, as an index among the cards it
    can see: its rank on this machine (LOCAL_RANK, as torchrun-style
    launchers set it).  None where the card is already chosen or no rank
    is known: CUDA_VISIBLE_DEVICES narrows what the process sees,
    JAX_LOCAL_DEVICE_IDS and the SLURM / Open MPI local ranks are read by
    jax.distributed itself."""
    if "CUDA_VISIBLE_DEVICES" in env or "JAX_LOCAL_DEVICE_IDS" in env:
        return None
    rank = env.get("LOCAL_RANK")
    return None if rank is None else [int(rank)]


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialise jax.distributed from args or SUBREAD_TPU_COORDINATOR /
    JAX standard env vars.  Returns True when a multi-process runtime is
    active.

    One process per card: on a machine with several GPUs a process that
    sees all of them reserves most of each card's memory, so the launcher
    gives each process its card (see `local_card`)."""
    import jax

    coordinator = coordinator or os.environ.get("SUBREAD_TPU_COORDINATOR")
    if coordinator is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return False
    kw = {}
    if coordinator:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    card = local_card()
    if card is not None:
        kw["local_device_ids"] = card
    jax.distributed.initialize(**kw)
    return jax.process_count() > 1


def host_shard_range(total: int, process_id: int, n_processes: int) -> range:
    """Contiguous read-index range this host owns (host-sharded input;
    the per-host analog of threads pulling chunks under input_lock,
    core.c:3379)."""
    per = -(-total // n_processes)
    start = process_id * per
    return range(start, min(start + per, total))


def global_reads_mesh():
    """1-D mesh over every card of every process ("reads" data
    parallelism)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("reads",))


def psum_stats(stats: dict[str, int]):
    """All-reduce small host statistics across processes (mapped/unique/…
    counter merge — finalise_indel_and_junction_thread analog,
    core-indel.c:1012).  Works single-process too."""
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return dict(stats)
    keys = sorted(stats)
    local = np.asarray([stats[k] for k in keys], np.int64)
    from jax.experimental import multihost_utils

    summed = multihost_utils.process_allgather(local).sum(axis=0)
    return {k: int(v) for k, v in zip(keys, summed)}


def allgather_event_table(
    lefts: np.ndarray, rights: np.ndarray, supports: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-host junction/indel event tables between scan 1 and
    scan 2 (the cross-host analog of the per-thread event-table merge).
    Events with equal (left, right) have their supports summed."""
    import jax

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        # variable-length per host: pad to the max length, mask by support
        n = np.asarray([len(lefts)], np.int64)
        n_all = multihost_utils.process_allgather(n).ravel()
        m = int(n_all.max())
        pad = lambda a: np.pad(a, (0, m - len(a)))
        lefts = multihost_utils.process_allgather(pad(lefts)).ravel()
        rights = multihost_utils.process_allgather(pad(rights)).ravel()
        supports = multihost_utils.process_allgather(pad(supports)).ravel()
        keep = supports > 0
        lefts, rights, supports = lefts[keep], rights[keep], supports[keep]
    # dedup-sum on (left, right)
    if len(lefts) == 0:
        return lefts, rights, supports
    order = np.lexsort((rights, lefts))
    l, r, s = lefts[order], rights[order], supports[order]
    new = np.concatenate(([True], (l[1:] != l[:-1]) | (r[1:] != r[:-1])))
    gid = np.cumsum(new) - 1
    out_l = l[new]
    out_r = r[new]
    out_s = np.bincount(gid, weights=s).astype(supports.dtype)
    return out_l, out_r, out_s


def merge_output_parts(out_path: str, n_processes: int) -> None:
    """Rank-0 concatenation of per-host output parts in process order
    (ordered gather of per-chip records, SURVEY §2)."""
    with open(out_path, "wb") as out:
        for p in range(n_processes):
            part = f"{out_path}.part-{p}"
            with open(part, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)
            os.remove(part)
