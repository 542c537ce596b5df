"""Benchmark suite vs the reference (BASELINE.md metrics).

Primary metric: subread-align 100bp SE reads/s per chip (chr901, as in
round 1).  Extra keys in the same JSON line (BASELINE.json names these
"measured configs"):

  * big-index align  — a 100 MB synthetic genome (index ~0.5 GB of
    combined rows in device memory): shows the vote-gather path at
    non-toy index scale.
  * featureCounts    — native C++ SE BAM path, rec/s end-to-end on a
    1M-record BAM; vs_binary uses the compiled reference featureCounts
    measured on a CPU host (2.0M rec/s end-to-end).
  * exactSNP         — wall seconds on the reference test BAM
    (test/exactSNP/data/test-in.BAM, 50k reads); output byte-checked
    against the pinned reference-binary VCF fixture.

Environment knobs: SUBREAD_BENCH_BIG=0 skips the 100 MB config (it
builds the index at bench time, ~2 min host work).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

BASELINE_READS_PER_SEC_PER_CORE = 233_000 / 10.0
# compiled reference featureCounts end-to-end on a CPU host, SE BAM: the
# round-1 record (commit b7134eb, STATUS.md row 21) has the native path at
# 2.8M rec/s = 1.4x the binary.  Not re-measured since.
FC_BINARY_REC_PER_SEC = 2_000_000.0

HERE = pathlib.Path(__file__).parent
CACHE = HERE / ".bench_cache"


def _measure_align(genome, index, n_reads=1 << 16, batch_reads=16384,
                   seed=12345, streams=6, chunks=6, depth=2):
    """Steady-state streaming reads/s, exactly as align_file drives the
    device (align_file submits 1M-read chunks = 64 sub-batch dispatch
    chains at once, so its device FIFO holds many batches; `depth`
    in-flight batches reproduce that queue depth here).  Best of
    `streams` runs."""
    from subread_tpu.align.pipeline import Aligner
    from subread_tpu.config import aligner_config
    from subread_tpu.utils.simulate import simulate_reads

    rng = np.random.default_rng(seed)
    batch, _ = simulate_reads(genome, n_reads, read_len=100, rng=rng,
                              error_rate=0.005)
    cfg = aligner_config(batch_reads=batch_reads)
    if batch.max_len < cfg.pad_read_len:
        # pre-pad to the standard width, exactly as FastqReader(pad_to=...)
        # delivers chunks to align_file — submit_batch then skips its copy
        pad = cfg.pad_read_len - batch.max_len
        batch.codes = np.pad(batch.codes, ((0, 0), (0, pad)))
        batch.quals = np.pad(batch.quals, ((0, 0), (0, pad)))
        batch.ambig = np.pad(batch.ambig, ((0, 0), (0, pad)))
    aligner = Aligner(genome, index, cfg)

    for _ in range(3):  # compile + first transfers
        aligner.align_batch(batch)

    per_stream = []
    res = None
    for _ in range(streams):
        t0 = time.time()
        q = []
        for _ in range(chunks):
            q.append(aligner.submit_batch(batch))
            if len(q) > depth:
                res = aligner.collect_batch(q.pop(0))
        while q:
            res = aligner.collect_batch(q.pop(0))
        per_stream.append(time.time() - t0)
    dt = min(per_stream) / chunks
    mapped = float(res["mapped"].sum()) / n_reads
    return n_reads / dt, mapped, dt * 1000 * batch_reads / n_reads


def bench_align_chr901(out):
    from subread_tpu.index.build import build_hash_index
    from subread_tpu.index.genome import genome_from_fasta

    genome = genome_from_fasta("/root/reference/test/chr901.fa")
    index = build_hash_index(genome, index_gap=1)
    rps, mapped, batch_ms = _measure_align(genome, index)
    out["metric"] = "subread-align reads/sec/chip (100bp SE, chr901)"
    out["value"] = round(rps, 1)
    out["unit"] = "reads/s"
    out["vs_baseline"] = round(rps / BASELINE_READS_PER_SEC_PER_CORE, 3)
    out["mapped_fraction"] = round(mapped, 4)
    # The reference binary (subread-align -t1) maps 0.9363 of this exact
    # read set (seed 12345, 0.5% error): chr901 is repeat-dense, and
    # equal-best repeat copies are break-even -> unreported by default.
    # The round-1 bench showed 0.9954 because its 7-bit check aliasing
    # overcounted votes and made repeat reads look unique; the drop to
    # ~0.937 in round 2 was the correctness fix, not a sensitivity loss.
    out["mapped_fraction_ref_binary"] = 0.9363
    out["batch_ms"] = round(batch_ms, 2)

    # gapped index (index_gap=3) — the reference's default for real
    # genomes (1/3 the index rows; voting probes all 3 phases).
    index_g = build_hash_index(genome, index_gap=3)
    rps_g, mapped_g, _ = _measure_align(genome, index_g, streams=3)
    out["gapped_reads_per_s"] = round(rps_g, 1)
    out["gapped_vs_baseline"] = round(
        rps_g / BASELINE_READS_PER_SEC_PER_CORE, 3
    )
    out["gapped_mapped_fraction"] = round(mapped_g, 4)


def _big_genome_index(n_bases=100_000_000, seed=77):
    """100 MB synthetic genome + full (gap=1) index, cached on disk so
    repeat bench runs skip the ~2 min build."""
    from subread_tpu.index.build import HashIndex
    from subread_tpu.index.genome import Genome, build_genome
    from subread_tpu.io.fasta import Contig

    CACHE.mkdir(exist_ok=True)
    gpfx = str(CACHE / f"big{n_bases // 1_000_000}")
    if os.path.exists(gpfx + ".genome.npz") and os.path.exists(gpfx + ".hash.npz"):
        return Genome.load(gpfx), HashIndex.load(gpfx)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n_bases).astype(np.uint8)
    # segmental duplications: 2% of the genome is copies of earlier 10 kb
    # segments, so repeat handling (multi-location ties) is exercised too
    for _ in range(n_bases // 500_000):
        src = int(rng.integers(0, n_bases - 10_000))
        dst = int(rng.integers(0, n_bases - 10_000))
        codes[dst:dst + 10_000] = codes[src:src + 10_000]
    contig = Contig(name="big1", codes=codes, ambig=np.zeros(n_bases, bool))
    genome = build_genome([contig])
    from subread_tpu.index.build import build_hash_index

    index = build_hash_index(genome, index_gap=1)
    try:
        genome.save(gpfx)
        index.save(gpfx)
    except OSError:
        pass
    return genome, index


def bench_align_big(out):
    genome, index = _big_genome_index()
    rps, mapped, _ = _measure_align(genome, index, seed=4242)
    out["bigindex_reads_per_s"] = round(rps, 1)
    out["bigindex_vs_baseline"] = round(rps / BASELINE_READS_PER_SEC_PER_CORE, 3)
    out["bigindex_mapped_fraction"] = round(mapped, 4)


def _fc_fixture(n_records=1_000_000):
    """1M-record SE BAM over chr901 + a SAF annotation, cached."""
    CACHE.mkdir(exist_ok=True)
    bam = CACHE / f"fc_se_{n_records // 1000}k.bam"
    saf = CACHE / "fc_bench.SAF"
    if bam.exists() and saf.exists():
        return str(bam), str(saf)
    from subread_tpu.index.genome import genome_from_fasta
    from subread_tpu.io.bam import BamWriter

    genome = genome_from_fasta("/root/reference/test/chr901.fa")
    L = int(genome.lengths[0])
    rng = np.random.default_rng(9)
    with open(saf, "w") as f:
        f.write("GeneID\tChr\tStart\tEnd\tStrand\n")
        start = 1
        g = 0
        while start + 2000 < L:
            flen = int(rng.integers(200, 2000))
            f.write(f"G{g % 800:04d}\tchr901\t{start}\t{start + flen}\t+\n")
            start += flen + int(rng.integers(50, 600))
            g += 1
    w = BamWriter(str(bam) + ".tmp", ["chr901"], [L])
    seq = "A" * 100
    qual = "h" * 100
    pos = rng.integers(1, L - 100, size=n_records)
    for i in range(n_records):
        w.add_sam_fields([
            f"r{i:07d}", "0", "chr901", str(int(pos[i])), "40", "100M",
            "*", "0", "0", seq, qual,
        ])
    w.close()
    os.replace(str(bam) + ".tmp", bam)
    return str(bam), str(saf)


def bench_featurecounts(out, tmpdir):
    from subread_tpu.tools.featurecounts import main as fc_main

    bam, saf = _fc_fixture()
    n_records = 1_000_000
    dest = os.path.join(tmpdir, "fc.out")
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        rc = fc_main(["-a", saf, "-F", "SAF", "-o", dest, bam])
        best = min(best, time.time() - t0)
    assert rc == 0
    assigned = 0
    for line in open(dest + ".summary"):
        if line.startswith("Assigned"):
            assigned = int(line.split()[1])
    rate = n_records / best
    out["featurecounts_rec_per_s"] = round(rate, 1)
    out["featurecounts_vs_ref_binary"] = round(rate / FC_BINARY_REC_PER_SEC, 3)
    out["featurecounts_assigned"] = assigned


def bench_align_pe(out):
    """PE + indel throughput (BASELINE.json measured config
    'subread-align PE + indel'): simulated 100bp pairs with 1% of
    fragments carrying an indel, streaming submit/collect like the SE
    row.  Reported per READ (2 per fragment)."""
    from subread_tpu.align.pipeline import Aligner
    from subread_tpu.config import aligner_config
    from subread_tpu.index.build import build_hash_index
    from subread_tpu.index.genome import genome_from_fasta
    from subread_tpu.utils.simulate import simulate_reads

    genome = genome_from_fasta("/root/reference/test/chr901.fa")
    index = build_hash_index(genome, index_gap=1)
    rng = np.random.default_rng(4242)
    n_pairs = 1 << 14
    b1, b2 = simulate_reads(
        genome, n_pairs, read_len=100, rng=rng, error_rate=0.005,
        indel_rate=0.01, paired=True,
    )
    # 8K pairs per sub-batch: PE saturation (either end) runs ~2x the SE
    # rate, so 16K-pair sub-batches overflow the 4096-row rescue tier
    # into the slow host pass
    cfg = aligner_config(batch_reads=8192)
    for b in (b1, b2):
        if b.max_len < cfg.pad_read_len:
            pad = cfg.pad_read_len - b.max_len
            b.codes = np.pad(b.codes, ((0, 0), (0, pad)))
            b.quals = np.pad(b.quals, ((0, 0), (0, pad)))
            b.ambig = np.pad(b.ambig, ((0, 0), (0, pad)))
    al = Aligner(genome, index, cfg)
    for _ in range(2):
        al.align_batch_pe(b1, b2)
    best = 0.0
    res = None
    for _ in range(3):
        t0 = time.time()
        q = []
        for _ in range(4):
            q.append(al.submit_batch_pe(b1, b2))
            if len(q) > 1:
                res = al.collect_batch_pe(q.pop(0))
        while q:
            res = al.collect_batch_pe(q.pop(0))
        best = max(best, 4 * 2 * n_pairs / (time.time() - t0))
    r1, _r2 = res
    mapped = float(np.asarray(r1["mapped"], bool).mean())
    out["pe_reads_per_s"] = round(best, 1)
    out["pe_vs_baseline"] = round(best / BASELINE_READS_PER_SEC_PER_CORE, 3)
    out["pe_mapped_fraction_r1"] = round(mapped, 4)


def bench_subjunc(out):
    """subjunc junction detection (BASELINE.json measured config): the
    reference's own junction-reads-A.fq (16052 reads) end-to-end through
    align_file in subjunc mode — includes junction discovery, seeding,
    event rescue, chaining and .junction.bed output."""
    import tempfile

    from subread_tpu.align.pipeline import Aligner
    from subread_tpu.config import subjunc_config
    from subread_tpu.index.build import build_hash_index
    from subread_tpu.index.genome import genome_from_fasta

    reads = "/root/reference/test/subjunc/data/junction-reads-A.fq"
    if not os.path.exists(reads):
        return
    genome = genome_from_fasta("/root/reference/test/chr901.fa")
    index = build_hash_index(genome, index_gap=1)
    al = Aligner(genome, index, subjunc_config(batch_reads=8192))
    best = 0.0
    n = 16052
    with tempfile.TemporaryDirectory() as td:
        for _ in range(2):
            t0 = time.time()
            s = al.align_file(reads, os.path.join(td, "j.sam"))
            best = max(best, n / (time.time() - t0))
        out["subjunc_reads_per_s"] = round(best, 1)
        out["subjunc_mapped_fraction"] = round(s.mapped / s.total, 4)


def bench_devicecounts(out, tmpdir):
    """Device counting (quant.device_count, the --deviceCounts CLI path),
    measured END-TO-END on the 1M-record bench BAM: native record parse
    (fc_read_sections_bam) + window mapping + upload + kernel + fetch —
    what a user actually gets.  The kernel-only rate is reported
    separately for the scaling story."""
    import jax

    from subread_tpu.io.gtf import load_annotation
    from subread_tpu.quant.device_count import DeviceCounter

    bam, saf = _fc_fixture()
    ann = load_annotation(saf, fmt="SAF")
    dc = DeviceCounter(ann)
    # end-to-end: parse + map + count (includes the upload)
    t0 = time.time()
    ss, se, gate, stbl = dc.sections_from_file(bam)
    t_parse = time.time() - t0
    n = len(gate)
    c, s, _, ov = dc.count(ss, se, gate, stbl)
    best_e2e = time.time() - t0
    for _ in range(2):
        t0 = time.time()
        ss, se, gate, stbl = dc.sections_from_file(bam)
        c, s, _, ov = dc.count(ss, se, gate, stbl)
        best_e2e = min(best_e2e, time.time() - t0)
    out["devicecounts_e2e_rec_per_s"] = round(n / best_e2e, 1)
    out["devicecounts_parse_s"] = round(t_parse, 3)
    out["devicecounts_assigned"] = int(s[0])

    # kernel-only rate (sections resident on device)
    import jax.numpy as jnp

    d_args = tuple(jnp.asarray(a) for a in (ss, se, gate, stbl))
    fn = jax.jit(dc._kernel)
    r = fn(*d_args)
    np.asarray(jax.device_get(r[1][:1]))
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        r = fn(*d_args)
        np.asarray(jax.device_get(r[1][:1]))
        best = min(best, time.time() - t0)
    out["devicecounts_rec_per_s"] = round(n / best, 1)


def bench_exactsnp(out, tmpdir):
    bam = "/root/reference/test/exactSNP/data/test-in.BAM"
    fasta = "/root/reference/test/chr901.fa"
    golden = HERE / "tests" / "data" / "exactSNP-chr901.ref.vcf"
    if not os.path.exists(bam):
        return
    from subread_tpu.tools.exactsnp import main as snp_main

    dest = os.path.join(tmpdir, "snp.vcf")
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        rc = snp_main(["-g", fasta, "-i", bam, "-o", dest])
        best = min(best, time.time() - t0)
    assert rc == 0
    strip = lambda p: [l for l in open(p).read().splitlines()
                       if not l.startswith("##exactSNP_Commandline")]
    out["exactsnp_wall_s"] = round(best, 3)
    out["exactsnp_output_ok"] = strip(dest) == strip(golden)


def main():
    from subread_tpu.utils.jaxenv import ensure_compile_cache

    ensure_compile_cache()
    import tempfile

    out = {}
    bench_align_chr901(out)
    if os.environ.get("SUBREAD_BENCH_PE", "1") != "0":
        bench_align_pe(out)
    if os.environ.get("SUBREAD_BENCH_SUBJUNC", "1") != "0":
        bench_subjunc(out)
    with tempfile.TemporaryDirectory() as td:
        bench_featurecounts(out, td)
        bench_devicecounts(out, td)
        bench_exactsnp(out, td)
    if os.environ.get("SUBREAD_BENCH_BIG", "1") != "0":
        bench_align_big(out)
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
