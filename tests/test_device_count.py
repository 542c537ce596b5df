"""Device-side featureCounts counting (quant/device_count.py): the
disjoint-span searchsorted kernel must reproduce the host FeatureCounter
exactly, single-device and psum-merged over an 8-device CPU mesh
(readSummary.c:1592-1680 binary search + :5795 fc_thread_merge_results
equivalents)."""

import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

DATA = pathlib.Path("/root/reference/test/featureCounts/data")
pytestmark = pytest.mark.skipif(
    not DATA.exists(), reason="reference data missing"
)


def _host_counts(sam, gtf, strand=0):
    from subread_tpu.io.gtf import load_annotation
    from subread_tpu.quant.featurecounts import FCOptions, FeatureCounter

    ann = load_annotation(str(gtf), fmt="GTF")
    fc = FeatureCounter(ann, FCOptions(strand=strand))
    fc.count_sam(str(sam), orphan_budget=None)
    return ann, fc


def _device_counts(ann, sam, strand=0):
    from subread_tpu.quant.device_count import DeviceCounter

    dc = DeviceCounter(ann, strand=strand)
    ss, se, gate, stbl = dc.sections_from_sam(str(sam))
    with jax.default_device(jax.devices("cpu")[0]):
        out = dc.count(ss, se, gate, stbl)
    return dc, (ss, se, gate, stbl), out


def _check_equal(fc, counts, summary, overflow):
    from subread_tpu.quant.device_count import STATUS_NAMES

    assert overflow == 0
    np.testing.assert_array_equal(counts, fc.counts.astype(np.int64))
    for i, name in enumerate(STATUS_NAMES):
        assert summary[i] == fc.summary[name], (
            name, int(summary[i]), fc.summary[name]
        )
    # every fragment the host put in a category outside the device
    # path's scope would make the totals diverge
    covered = set(STATUS_NAMES)
    for name, v in fc.summary.items():
        if name not in covered:
            assert v == 0, (name, v)


@pytest.mark.parametrize("strand", [0, 1, 2])
def test_matches_host_counter_minimum(strand):
    sam = DATA / "test-minimum.sam"
    gtf = DATA / "test-minimum.GTF"
    ann, fc = _host_counts(sam, gtf, strand)
    _, _, (counts, summary, status, ov) = _device_counts(ann, sam, strand)
    assert fc.counts.sum() > 0
    _check_equal(fc, counts, summary, ov)


def test_matches_host_counter_junctions():
    sam = DATA / "test-junc.sam"
    gtf = DATA / "test-minimum.GTF"
    ann, fc = _host_counts(sam, gtf)
    _, _, (counts, summary, status, ov) = _device_counts(ann, sam)
    _check_equal(fc, counts, summary, ov)


def test_matches_host_counter_random(tmp_path):
    """Random overlapping genes + random reads (incl. spliced, unmapped,
    NH>1 multimappers): device path == host path."""
    rng = np.random.default_rng(7)
    gtf = tmp_path / "rand.gtf"
    with open(gtf, "w") as f:
        for g in range(40):
            chro = f"chr{rng.integers(1, 4)}"
            gs = int(rng.integers(1, 50_000))
            for _ in range(int(rng.integers(1, 4))):
                s = gs + int(rng.integers(0, 2000))
                e = s + int(rng.integers(50, 900))
                st = "+-"[int(rng.integers(0, 2))]
                f.write(
                    f"{chro}\tx\texon\t{s}\t{e}\t.\t{st}\t."
                    f'\tgene_id "G{g:03d}";\n'
                )
    sam = tmp_path / "rand.sam"
    with open(sam, "w") as f:
        f.write("@HD\tVN:1.0\n")
        for c in (1, 2, 3):
            f.write(f"@SQ\tSN:chr{c}\tLN:60000\n")
        for i in range(3000):
            chro = f"chr{rng.integers(1, 5)}"  # chr4 absent from anno
            pos = int(rng.integers(1, 55_000))
            flag = 16 if rng.random() < 0.5 else 0
            kind = rng.random()
            if kind < 0.05:
                f.write(f"r{i}\t4\t*\t0\t0\t*\t*\t0\t0\tA\tI\n")
                continue
            if kind < 0.25:
                cigar = f"40M{int(rng.integers(50, 3000))}N35M"
            elif kind < 0.32:
                cigar = "20M5D30M2I23M"
            else:
                cigar = "75M"
            tags = "\tNH:i:3" if rng.random() < 0.1 else ""
            f.write(
                f"r{i}\t{flag}\t{chro}\t{pos}\t30\t{cigar}\t*\t0\t0"
                f"\tA\tI{tags}\n"
            )
    for strand in (0, 1):
        ann, fc = _host_counts(sam, gtf, strand)
        _, _, (counts, summary, status, ov) = _device_counts(
            ann, sam, strand
        )
        _check_equal(fc, counts, summary, ov)


def test_sharded_counts_match_single_device():
    """8-device CPU mesh: per-chip partial counts + psum == single-device
    counts (per-thread table merge, readSummary.c:5795)."""
    from jax.sharding import Mesh

    sam = DATA / "test-junc.sam"
    gtf = DATA / "test-minimum.GTF"
    ann, fc = _host_counts(sam, gtf)
    dc, (ss, se, gate, stbl), (counts, summary, _, ov) = _device_counts(
        ann, sam
    )
    cpu = [d for d in jax.devices("cpu")][:8]
    assert len(cpu) == 8
    mesh = Mesh(np.array(cpu), ("reads",))
    c8, s8, ov8 = dc.count_sharded(mesh, ss, se, gate, stbl)
    np.testing.assert_array_equal(c8, counts)
    np.testing.assert_array_equal(s8, summary)
    assert ov8 == ov == 0
    np.testing.assert_array_equal(c8, fc.counts.astype(np.int64))


def test_cli_device_counts_byte_identical(tmp_path):
    """featureCounts --deviceCounts end-to-end: the CLI device path (PE
    fragments, psum merge over an 8-device CPU mesh) must write
    byte-identical counts + summary to the host path.  Runs in a
    JAX_PLATFORMS=cpu subprocess so jax.devices() IS the 8-CPU mesh."""
    import os
    import subprocess
    import sys

    gtf = DATA / "test-minimum.GTF"
    sam = DATA / "test-minimum.sam"
    host_out = tmp_path / "host.FC"
    dev_out = tmp_path / "dev.FC"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    for extra, out in ((), host_out), (("--deviceCounts",), dev_out):
        r = subprocess.run(
            [sys.executable, "-m", "subread_tpu.tools.featurecounts",
             "-p", "--countReadPairs", *extra, "-a", str(gtf),
             "-o", str(out), str(sam)],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr
    assert "counted on 8 device(s)" in r.stderr
    # identical modulo the header line (embeds the output path)
    strip = lambda p: "\n".join(open(p).read().splitlines()[1:])
    assert strip(host_out) == strip(dev_out)
    assert open(str(host_out) + ".summary").read().replace(
        str(host_out), "X"
    ) == open(str(dev_out) + ".summary").read().replace(str(dev_out), "X")


def test_cli_device_counts_se(tmp_path):
    """SE variant (each record its own fragment)."""
    from subread_tpu.tools.featurecounts import main

    gtf = DATA / "test-minimum.GTF"
    sam = DATA / "test-minimum.sam"
    host_out = tmp_path / "host.FC"
    dev_out = tmp_path / "dev.FC"
    with jax.default_device(jax.devices("cpu")[0]):
        assert main(["-a", str(gtf), "-o", str(host_out), str(sam)]) == 0
        assert main(["--deviceCounts", "-a", str(gtf),
                     "-o", str(dev_out), str(sam)]) == 0
    strip = lambda p: "\n".join(open(p).read().splitlines()[1:])
    assert strip(host_out) == strip(dev_out)
