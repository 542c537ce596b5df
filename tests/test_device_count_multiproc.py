"""Multi-host deviceCounts: a name-sharded BAM counted by two real
processes over jax.distributed, per-host count vectors psum-merged —
the device analog of the reference's per-thread count merge
(fc_thread_merge_results, readSummary.c:5795) at host scale."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

DATA = "/root/reference/test/featureCounts/data"

WORKER = r"""
import json, sys
import numpy as np
import jax
coord, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
jax.distributed.initialize(coord, num_processes=2, process_id=pid)

from subread_tpu.io.gtf import load_annotation
from subread_tpu.quant.device_count import DeviceCounter

D = "/root/reference/test/featureCounts/data"
ann = load_annotation(f"{D}/test-minimum.GTF", fmt="GTF",
                      feature_type="exon", attr_type="gene_id")
dc = DeviceCounter(ann, strand=0, max_sections=20)
# every host parses the BAM identically, then counts ONLY its shard of
# the fragment rows (name-sharding: fragments are qname-grouped rows)
ss, se, gate, stbl = dc.fragments_from_file(sys.argv[4])
F = len(gate)
lo, hi = (0, F // 2) if pid == 0 else (F // 2, F)
c, s, _, ov = dc.count(ss[lo:hi], se[lo:hi], gate[lo:hi], stbl[lo:hi])
assert ov == 0
# all-reduce the per-host count vectors across the two processes
from jax.experimental import multihost_utils
merged = multihost_utils.process_allgather(
    np.asarray(c, np.int64)).sum(axis=0)
json.dump({"counts": np.asarray(merged).tolist(),
           "local": c.tolist()}, open(f"{outdir}/dc-{pid}.json", "w"))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_devicecounts_bam(tmp_path):
    import pytest

    if not os.path.exists(f"{DATA}/test-minimum.sam"):
        pytest.skip("reference fixture missing")
    # make a BAM of the SAM fixture with our own writer
    from subread_tpu.io import sam as samio
    from subread_tpu.io.gtf import load_annotation
    from subread_tpu.quant.featurecounts import FCOptions, FeatureCounter

    names, lens = [], []
    for line in open(f"{DATA}/test-minimum.sam"):
        if line.startswith("@SQ"):
            d = dict(f.split(":", 1) for f in line.rstrip().split("\t")[1:])
            names.append(d["SN"])
            lens.append(int(d["LN"]))
        elif not line.startswith("@"):
            break
    bam = str(tmp_path / "in.bam")
    w = samio.make_writer(bam, names, lens, sam_output=False)
    for line in open(f"{DATA}/test-minimum.sam"):
        if not line.startswith("@"):
            w.write_line(line.rstrip("\n"))
    w.close()

    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(tmp_path),
             bam],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    res = [json.load(open(tmp_path / f"dc-{pid}.json")) for pid in range(2)]
    # both hosts hold the same merged vector; shards differ
    assert res[0]["counts"] == res[1]["counts"]
    assert res[0]["local"] != res[1]["local"]

    # merged counts == the host engine's golden counts on the same BAM
    ann = load_annotation(f"{DATA}/test-minimum.GTF", fmt="GTF",
                          feature_type="exon", attr_type="gene_id")
    fc = FeatureCounter(ann, FCOptions(paired=True, count_read_pairs=True))
    fc.count_file(bam)
    assert res[0]["counts"] == [int(x) for x in fc.counts]
