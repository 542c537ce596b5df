"""Real multi-process DCN tests for parallel.distributed.

Spawns two CPU subprocesses connected via jax.distributed.initialize,
and exercises the cross-host primitives: psum_stats,
allgather_event_table (variable-length per host), and the rank-0 ordered
output merge.  This is the coordination layer the aligner
uses across hosts (SURVEY.md §2 distributed-backend mandate); the compute
path itself is covered by the CPU-mesh tests in test_parallel.py.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import json, sys
import numpy as np
from subread_tpu.parallel import distributed as D

coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
active = D.init_distributed(coord, num_processes=2, process_id=pid)
import jax
assert active and jax.process_count() == 2, jax.process_count()

# 1. psum_stats: distinct per-host counters -> global sums everywhere
stats = D.psum_stats({"mapped": 10 + pid, "unique": 5 * (pid + 1)})

# 2. allgather_event_table: different lengths per host, one shared event
if pid == 0:
    lefts = np.array([100, 200, 300], np.int64)
    rights = np.array([150, 250, 350], np.int64)
    sups = np.array([3, 1, 2], np.int64)
else:
    lefts = np.array([200, 400], np.int64)
    rights = np.array([250, 450], np.int64)
    sups = np.array([4, 7], np.int64)
l, r, s = D.allgather_event_table(lefts, rights, sups)

# 3. ordered output parts + rank-0 merge
out = f"{outdir}/merged.out"
with open(f"{out}.part-{pid}", "w") as f:
    f.write(f"host{pid} line\n")
from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("parts written")
if pid == 0:
    D.merge_output_parts(out, 2)

result = dict(
    stats=stats,
    events=[[int(x) for x in l], [int(x) for x in r], [int(x) for x in s]],
)
with open(f"{outdir}/result-{pid}.json", "w") as f:
    json.dump(result, f)
"""


ALIGN_WORKER = r"""
import json, sys
import numpy as np
from subread_tpu.parallel import distributed as D

coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
assert D.init_distributed(coord, num_processes=2, process_id=pid)
import jax

from subread_tpu.align.pipeline import Aligner
from subread_tpu.config import aligner_config
from subread_tpu.index.build import build_hash_index
from subread_tpu.index.genome import genome_from_fasta
from subread_tpu.io.fastq import ReadBatch

g = genome_from_fasta("/root/reference/test/chr901.fa")
idx = build_hash_index(g, index_gap=1)
al = Aligner(g, idx, aligner_config(batch_reads=256, pad_read_len=128))

# every host derives the same global read set, then aligns only its shard
rng = np.random.default_rng(31)
total, L = 512, 100
starts = rng.integers(2000, 900000, total)
lin = g.chro_to_linear(0, 0) + starts
shard = D.host_shard_range(total, pid, 2)
codes = np.stack([g.codes[p : p + L] for p in lin[list(shard)]])
n = len(codes)
batch = ReadBatch(
    names=[f"r{i}" for i in shard], codes=codes,
    lengths=np.full(n, L, np.int32),
    quals=np.full((n, L), 73, np.uint8), ambig=np.zeros((n, L), bool),
)
res = al.align_batch(batch)
stats = D.psum_stats({"mapped": int(res["mapped"].sum()), "total": n})
out = f"{outdir}/aligned.tsv"
with open(f"{out}.part-{pid}", "w") as f:
    for j, i in enumerate(shard):
        f.write(f"r{i}\t{int(res['pos'][j])}\t{int(starts[i])}\n")
from jax.experimental import multihost_utils
multihost_utils.sync_global_devices("aligned")
if pid == 0:
    D.merge_output_parts(out, 2)
    json.dump(stats, open(f"{outdir}/stats.json", "w"))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    # LOCAL_RANK takes init_distributed's one-card-per-process path
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(tmp_path)],
            env=dict(env, LOCAL_RANK=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    results = [
        json.load(open(tmp_path / f"result-{pid}.json")) for pid in range(2)
    ]
    # psum: mapped = 10 + 11, unique = 5 + 10 on BOTH hosts
    for res in results:
        assert res["stats"] == {"mapped": 21, "unique": 15}
    # event union: (200,250) support-summed 1+4=5, others passed through
    for res in results:
        l, r, s = res["events"]
        table = dict(zip(zip(l, r), s))
        assert table == {
            (100, 150): 3, (200, 250): 5, (300, 350): 2, (400, 450): 7,
        }
    merged = open(tmp_path / "merged.out").read()
    assert merged == "host0 line\nhost1 line\n"


def test_two_process_distributed_alignment(tmp_path, chr901_genome):
    """End-to-end 2-host alignment: host-sharded reads, psum'd summary
    stats, rank-0 ordered SAM-part merge; every read must map to its
    simulated position."""
    worker = tmp_path / "worker.py"
    worker.write_text(ALIGN_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    stats = json.load(open(tmp_path / "stats.json"))
    # ~8% of chr901 positions sit in exact duplicated blocks: those reads
    # are break-even multi-mappers the reference does not report (its own
    # SE fixture leaves 7.5% unmapped) — 512*0.92 ≈ 470
    assert stats["total"] == 512 and stats["mapped"] >= 455, stats
    lines = open(tmp_path / "aligned.tsv").read().splitlines()
    assert len(lines) == 512
    assert [l.split("\t")[0] for l in lines[:3]] == ["r0", "r1", "r2"]
    base = int(chr901_genome.chro_to_linear(0, 0))
    n_ok = sum(
        1 for l in lines
        if abs(int(l.split("\t")[1]) - (base + int(l.split("\t")[2]))) <= 8
    )
    # chr901 is duplication-heavy: reads from exact duplicated blocks are
    # break-even multi-mappers (dropped, reference semantics), and a few
    # more legitimately map to another repeat copy
    assert n_ok >= 450, n_ok


@pytest.mark.parametrize(
    "env, card",
    [
        ({}, None),
        ({"LOCAL_RANK": "2"}, [2]),
        # the launcher narrowed the visible cards: rank no longer indexes them
        ({"LOCAL_RANK": "2", "CUDA_VISIBLE_DEVICES": "5"}, None),
        # jax.distributed reads these itself
        ({"LOCAL_RANK": "1", "JAX_LOCAL_DEVICE_IDS": "3"}, None),
        ({"SLURM_LOCALID": "1"}, None),
    ],
)
def test_local_card(env, card):
    from subread_tpu.parallel.distributed import local_card

    assert local_card(env) == card
