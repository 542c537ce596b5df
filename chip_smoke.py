#!/usr/bin/env python3
"""Smoke run of the main path on one NVIDIA GPU, through the user-facing CLIs.

    python3 chip_smoke.py                 # phases 0-5 on one card
    python3 chip_smoke.py --four-cards    # the four-card phase only: four
                                          # processes one card each, then
                                          # sharded counting and align step

Phases, each printing one line of its own numbers:

  0 device    the GPU backend is up and the native C++ library built
  1 index     seeded 100 Mbp genome, full index through tools/buildindex
  2 SE        1,000,000 x 100bp reads through tools/align -> BAM
  3 PE        250,000 pairs (1% indels) through tools/align -R -> BAM
  4 GPU=CPU   one SE and one PE sub-batch on the GPU and on the CPU
              backend; every result array must be equal (the program is
              integer-only, so the tolerance is zero)
  5 counting  featureCounts --deviceCounts on the phase-2 BAM equal to the
              native host counter, with no host fallback taken

The last line of stdout is {"ok": true, "device": {...}}.  A failed phase
raises, so the script exits non-zero without that line.  Everything runs
in this one process (a JAX process reserves most of a card's memory).

Work files go to .smoke/ in the checkout (listed in .gitignore).  The
index is kept there, keyed by genome size and seed, and reused when
present.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
WORK = HERE / ".smoke"

# Gates on the reads' primary records.  Accuracy: the fraction of all
# reads placed within 1200bp of a simulated origin (reference
# readname_ora_match semantics).  Precision: the same count over mapped
# reads only.  Reads from the genome's exact segmental duplications (about
# 4% of it, both copies) are break-even multi-mappers, which subread-align
# leaves unmapped by default, so accuracy sits near 0.95.  CPU runs of
# seed 2024 (2 Mbp / 20K reads, 10 Mbp / 50K reads) gave SE accuracy
# 0.9522 / 0.9554, PE accuracy 0.9574 / 0.9617, properly paired
# 0.9562 / 0.9595, and precision 1.0000 in all four; the gates leave room
# for how the duplications fall at other genome sizes.
SE_ACCURACY_GATE = 0.94
PE_ACCURACY_GATE = 0.94
PE_PROPER_GATE = 0.94
PRECISION_GATE = 0.995

READ_LEN = 100


def require(ok, message: str) -> None:
    """A phase's check; raising ends the run without the result line."""
    if not ok:
        raise RuntimeError(message)


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in numbers.items()),
          flush=True)


class CompileClock:
    """Seconds JAX spends compiling (or loading from the persistent cache)
    and tracing/lowering, read from jax.monitoring events."""

    _COMPILE = "/jax/core/compile/backend_compile_duration"
    _TRACE = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration")

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.trace_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == self._COMPILE:
            self.compile_s += duration
        elif event in self._TRACE:
            self.trace_s += duration

    def snapshot(self) -> tuple[float, float]:
        return self.compile_s, self.trace_s


# --- phase 0: device -----------------------------------------------------


def require_checkout() -> None:
    try:
        import subread_tpu
    except ImportError:
        raise SystemExit(
            "chip_smoke.py: run it from the root of a subread_tpu checkout")
    if pathlib.Path(subread_tpu.__file__).resolve().parents[1] != HERE:
        raise SystemExit(
            f"chip_smoke.py: subread_tpu was imported from "
            f"{subread_tpu.__file__}, not from this checkout")


def require_gpus(n: int):
    """The GPU devices, or exit: JAX falls back to the CPU with only a
    warning when the CUDA plugin fails to load."""
    import jax

    backend = jax.default_backend()
    devs = jax.devices()
    if backend != "gpu" or devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py: no GPU (JAX backend {backend!r}, "
            f"devices {devs})")
    if len(devs) < n:
        raise SystemExit(f"chip_smoke.py: need {n} GPUs, have {len(devs)}")
    return devs


def phase_device(devs) -> None:
    import jax
    import jaxlib

    from subread_tpu import native
    from subread_tpu.utils.jaxenv import ensure_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    for line in smi:
        print(f"nvidia-smi: {line}", flush=True)
    cache = ensure_compile_cache()
    if native.get_lib() is None:
        raise SystemExit(
            f"native library did not build:\n{native.build_error()}")
    log("0-device", platform=devs[0].platform,
        kind=repr(devs[0].device_kind), count=len(devs),
        jax=jax.__version__, jaxlib=jaxlib.__version__,
        XLA_FLAGS=repr(os.environ.get("XLA_FLAGS", "")),
        compile_cache=cache, native="built")


# --- phase 1: genome and index -------------------------------------------


def make_genome(n_bases: int, seed: int, n_contigs: int = 4):
    """Seeded genome: uniform background, tandem-repeat blocks (0.5% of
    the genome, units of 1-60bp) and 2% exact segmental duplications
    (copies of 10 kb segments), split into n_contigs chromosomes."""
    from subread_tpu.io.fasta import Contig

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n_bases, dtype=np.uint8)
    for _ in range(n_bases // 200_000):
        unit = rng.integers(0, 4, size=int(rng.integers(1, 61)),
                            dtype=np.uint8)
        span = int(rng.integers(200, 2001))
        dst = int(rng.integers(0, n_bases - span))
        codes[dst:dst + span] = np.resize(unit, span)
    for _ in range(n_bases // 500_000):
        src, dst = (int(x) for x in rng.integers(0, n_bases - 10_000, 2))
        codes[dst:dst + 10_000] = codes[src:src + 10_000]
    bounds = np.linspace(0, n_bases, n_contigs + 1).astype(np.int64)
    return [
        Contig(name=f"chr{c + 1}", codes=codes[bounds[c]:bounds[c + 1]],
               ambig=np.zeros(int(bounds[c + 1] - bounds[c]), bool))
        for c in range(n_contigs)
    ]


def write_fasta(path: pathlib.Path, contigs, width: int = 70) -> None:
    from subread_tpu.dna import CODE2BASE

    with open(path, "wb") as f:
        for c in contigs:
            f.write(f">{c.name}\n".encode())
            text = CODE2BASE[c.codes]
            pad = -len(text) % width
            rows = np.concatenate([text, np.full(pad, ord("\n"), np.uint8)])
            rows = rows.reshape(-1, width)
            body = np.concatenate(
                [rows, np.full((len(rows), 1), ord("\n"), np.uint8)], axis=1
            ).tobytes().rstrip(b"\n")
            f.write(body + b"\n")


def phase_index(genome_mbp: int, seed: int) -> dict:
    """Build (or reuse) the full index of the seeded genome through the
    buildindex CLI; returns its prefix and the seconds it took."""
    from subread_tpu.tools import buildindex

    d = WORK / "index" / f"g{genome_mbp}m_s{seed}"
    prefix, fasta = str(d / "genome"), d / "genome.fa"
    out = {"prefix": prefix, "genome_mbp": genome_mbp, "seed": seed,
           "genome_gen_s": "reused", "build_s": "reused"}
    if not os.path.exists(prefix + ".log"):  # the CLI writes .log last
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        write_fasta(fasta, make_genome(genome_mbp * 1_000_000, seed))
        out["genome_gen_s"] = f"{time.perf_counter() - t0:.1f}"
        t0 = time.perf_counter()
        rc = buildindex.main(["-F", "-o", prefix, str(fasta)])
        require(rc == 0, f"buildindex exited {rc}")
        out["build_s"] = f"{time.perf_counter() - t0:.1f}"
    # the -M block budget (8000 MB by default) must keep this index whole
    require(os.path.exists(prefix + ".hash.npz"),
            "the index was split into blocks")
    return out


def aligner_bytes(al) -> int:
    return int(sum(a.nbytes for blk in al.d_blocks for a in blk)
               + al.d_genome.nbytes)


def peak_bytes(dev) -> int | None:
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# --- phases 2-3: alignment through the CLI -------------------------------


def parse_bam(path: str):
    """(names, flags, ref_names[ref_id], 1-based pos) of every record of a
    BAM, reading only each record's fixed fields and name."""
    import struct

    from subread_tpu.io.bam import bgzf_decompress

    data = bgzf_decompress(path)
    require(data[:4] == b"BAM\x01", f"{path} is not a BAM file")
    off = 8 + struct.unpack_from("<i", data, 4)[0]
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        refs.append(data[off + 4:off + 3 + l_name].decode())
        off += 8 + l_name
    names, flags, rids, pos = [], [], [], []
    n = len(data)
    while off + 4 <= n:
        size, rid, p, l_qn = struct.unpack_from("<iiiB", data, off)
        flags.append(struct.unpack_from("<H", data, off + 18)[0])
        names.append(data[off + 36:off + 35 + l_qn].decode())
        rids.append(rid)
        pos.append(p + 1)
        off += 4 + size
    ref_of = np.array(refs + ["*"], dtype=object)
    return (names, np.asarray(flags, np.int64),
            ref_of[np.asarray(rids, np.int64)], np.asarray(pos, np.int64))


def origin_hits(names, chroms, pos) -> np.ndarray:
    """Per record: placed within 1200bp of either simulated origin encoded
    in the read name (``{chro}_{pos1}_{pos2}_...``)."""
    parts = [nm.split("_", 3) for nm in names]
    t_chr = np.array([p[0] for p in parts], dtype=object)
    p1 = np.array([int(p[1]) for p in parts], np.int64)
    p2 = np.array([int(p[2]) for p in parts], np.int64)
    near = np.minimum(np.abs(pos - p1), np.abs(pos - p2)) <= 1200
    return (chroms == t_chr) & near


def run_cli_twice(argv: list[str], out: str, clock: CompileClock) -> dict:
    """Run tools/align cold (compiles) and warm (persistent-cache loads
    only); both must write the same bytes."""
    from subread_tpu.tools import align

    times = {}
    for run in ("cold", "warm"):
        dest = out if run == "warm" else out + ".cold.bam"
        c0, t0 = clock.snapshot()
        w0 = time.perf_counter()
        rc = align.main(argv + ["-o", dest])
        require(rc == 0, f"align exited {rc}")
        c1, t1 = clock.snapshot()
        times[run] = (time.perf_counter() - w0, c1 - c0, t1 - t0)
    with open(out + ".cold.bam", "rb") as a, open(out, "rb") as b:
        require(a.read() == b.read(),
                "cold and warm runs wrote different BAMs")
    os.remove(out + ".cold.bam")
    return times


def _time_fields(times: dict, n_reads: int) -> dict:
    (cw, cc, ct), (ww, wc, wt) = times["cold"], times["warm"]
    return dict(cold_wall_s=f"{cw:.2f}", cold_compile_s=f"{cc:.2f}",
                cold_trace_lower_s=f"{ct:.2f}", warm_wall_s=f"{ww:.2f}",
                warm_compile_s=f"{wc:.2f}", warm_trace_lower_s=f"{wt:.2f}",
                warm_reads_per_s=f"{n_reads / ww:.0f}")


def check_placements(bam: str, n_records: int) -> dict:
    """One primary record per read, and the origin-accuracy and precision
    gates; returns the fractions (and the BAM's record count)."""
    names, flags, chroms, pos = parse_bam(bam)
    primary = (flags & 0x900) == 0
    require(primary.sum() == n_records,
            f"{primary.sum()} primary records for {n_records} reads")
    mates = {(nm, f & 0xC0) for nm, f, p in zip(names, flags.tolist(), primary)
             if p}
    require(len(mates) == n_records, "a read has two primary records")
    mapped = primary & ((flags & 0x4) == 0)
    hits = int((origin_hits(names, chroms, pos) & mapped).sum())
    out = dict(records=len(names), mapped=mapped.sum() / n_records,
               accuracy=hits / n_records,
               precision=hits / max(int(mapped.sum()), 1),
               proper=(primary & ((flags & 0x2) != 0)).sum() / n_records)
    require(out["precision"] >= PRECISION_GATE,
            f"precision {out['precision']:.4f} below {PRECISION_GATE}")
    return out


def _simulate_to_fastq(prefix: str, n: int, seed: int, paired: bool):
    from subread_tpu.index.genome import Genome
    from subread_tpu.utils.simulate import simulate_reads, write_fastq

    run = WORK / "run"
    run.mkdir(parents=True, exist_ok=True)
    kw = dict(indel_rate=0.01, paired=True) if paired else {}
    b1, b2 = simulate_reads(Genome.load(prefix), n, READ_LEN,
                            error_rate=0.005,
                            rng=np.random.default_rng(seed), **kw)
    tag = "pe" if paired else "se"
    paths = [str(run / f"{tag}_{m + 1}.fq") for m in range(1 + paired)]
    for path, b in zip(paths, (b1, b2)):
        write_fastq(path, b)
    return paths, str(run / f"{tag}.bam")


def phase_se(prefix: str, n_reads: int, seed: int, device,
             clock: CompileClock) -> dict:
    """SE reads through tools/align on `device`, checked against their
    simulated origins.  Returns the BAM path and its numbers."""
    import jax

    (fq,), bam = _simulate_to_fastq(prefix, n_reads, seed + 1, paired=False)
    with jax.default_device(device):
        times = run_cli_twice(["-t", "1", "-i", prefix, "-r", fq], bam, clock)
    got = check_placements(bam, n_reads)
    log("2-se", reads=n_reads, mapped=f"{got['mapped']:.4f}",
        accuracy=f"{got['accuracy']:.4f}", gate=SE_ACCURACY_GATE,
        precision=f"{got['precision']:.4f}",
        **_time_fields(times, n_reads))
    require(got["accuracy"] >= SE_ACCURACY_GATE, "SE accuracy below the gate")
    return dict(got, bam=bam)


def phase_pe(prefix: str, n_pairs: int, seed: int, device,
             clock: CompileClock) -> dict:
    """PE pairs (1% carry an indel) through tools/align -R on `device`."""
    import jax

    (fq1, fq2), bam = _simulate_to_fastq(prefix, n_pairs, seed + 2,
                                         paired=True)
    with jax.default_device(device):
        times = run_cli_twice(
            ["-t", "1", "-i", prefix, "-r", fq1, "-R", fq2], bam, clock)
    got = check_placements(bam, 2 * n_pairs)
    log("3-pe", pairs=n_pairs, mapped=f"{got['mapped']:.4f}",
        accuracy=f"{got['accuracy']:.4f}", gate=PE_ACCURACY_GATE,
        precision=f"{got['precision']:.4f}",
        proper_pairs=f"{got['proper']:.4f}", proper_gate=PE_PROPER_GATE,
        **_time_fields(times, 2 * n_pairs))
    require(got["accuracy"] >= PE_ACCURACY_GATE, "PE accuracy below the gate")
    require(got["proper"] >= PE_PROPER_GATE, "proper pairs below the gate")
    return dict(got, bam=bam)


# --- phase 4: GPU results equal to CPU results ---------------------------


def require_equal_results(a: dict, b: dict, what: str) -> int:
    """Every result array equal (dtype, shape, values); returns the number
    of arrays compared."""
    require(sorted(a) == sorted(b), f"{what}: keys {sorted(a)} != {sorted(b)}")
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or hasattr(x, "dtype"):
            x, y = np.asarray(x), np.asarray(y)
            require(x.dtype == y.dtype and x.shape == y.shape,
                    f"{what}[{k}]: {x.dtype}{x.shape} != {y.dtype}{y.shape}")
            if not np.array_equal(x, y):
                bad = np.flatnonzero((x != y).reshape(len(x), -1).any(-1))
                raise RuntimeError(
                    f"{what}[{k}] differs in {len(bad)} reads, first "
                    f"rows {bad[:8].tolist()}")
        else:
            require(x == y, f"{what}[{k}] differs")
    return len(a)


def sub_batches(prefix: str, seed: int, n_se: int, n_pe: int):
    from subread_tpu.index.genome import Genome
    from subread_tpu.utils.simulate import simulate_reads

    genome = Genome.load(prefix)
    se, _ = simulate_reads(genome, n_se, READ_LEN, error_rate=0.005,
                           rng=np.random.default_rng(seed + 3))
    p1, p2 = simulate_reads(genome, n_pe, READ_LEN, error_rate=0.005,
                            indel_rate=0.01, paired=True,
                            rng=np.random.default_rng(seed + 4))
    return se, p1, p2


def make_aligners(prefix: str, device, se_batch: int, pe_batch: int):
    import jax

    from subread_tpu.align.pipeline import Aligner
    from subread_tpu.config import aligner_config
    from subread_tpu.tools.align import load_index_any

    genome, index = load_index_any(prefix)
    with jax.default_device(device):
        return (Aligner(genome, index, aligner_config(batch_reads=se_batch)),
                Aligner(genome, index, aligner_config(batch_reads=pe_batch)))


def phase_equal(prefix: str, seed: int, gpu, cpu, gpu_aligners,
                n_se: int = 16384, n_pe: int = 8192) -> None:
    import jax

    se, p1, p2 = sub_batches(prefix, seed, n_se, n_pe)
    results = {}
    for name, dev, (al_se, al_pe) in (
        ("gpu", gpu, gpu_aligners),
        ("cpu", cpu, make_aligners(prefix, cpu, n_se, n_pe)),
    ):
        for al in (al_se, al_pe):
            require(al.d_genome.devices() == {dev}
                    and al.d_comb.devices() == {dev},
                    f"the {name} aligner's index is not on {dev}")
        with jax.default_device(dev):
            t0 = time.perf_counter()
            r_se = al_se.align_batch(se)
            t_se = time.perf_counter() - t0
            t0 = time.perf_counter()
            r_pe = al_pe.align_batch_pe(p1, p2)
            t_pe = time.perf_counter() - t0
        results[name] = (r_se, r_pe, t_se, t_pe)
    g, c = results["gpu"], results["cpu"]
    n = require_equal_results(g[0], c[0], "SE")
    n += require_equal_results(g[1][0], c[1][0], "PE mate 1")
    n += require_equal_results(g[1][1], c[1][1], "PE mate 2")
    log("4-gpu=cpu", se_reads=n_se, pe_pairs=n_pe, arrays_equal=n,
        gpu_se_s=f"{g[2]:.2f}", gpu_pe_s=f"{g[3]:.2f}",
        cpu_se_s=f"{c[2]:.2f}", cpu_pe_s=f"{c[3]:.2f}",
        note="first_calls_include_compile")


# --- optional: a profiler trace of one warm SE sub-batch -----------------


def summarize_trace(trace_dir: str, top: int = 12) -> dict:
    """Device time per op over the GPU stream lines of the newest trace in
    trace_dir, the busy share of the traced window, and the number of
    device-to-host copies; writes the whole per-op table to ops.tsv."""
    import collections
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))[-1]
    per_op, count = collections.Counter(), collections.Counter()
    spans, lines = [], set()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_op[ev.name] += ev.duration_ns
                count[ev.name] += 1
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, end = 0, None
    for a0, a1 in spans:
        if end is None or a0 > end:
            busy += a1 - a0
            end = a1
        elif a1 > end:
            busy += a1 - end
            end = a1
    window = (max(e for _, e in spans) - spans[0][0]) if spans else 0
    with open(pathlib.Path(trace_dir) / "ops.tsv", "w") as f:
        f.write("op\tcalls\tdevice_ns\n")
        for name, ns in per_op.most_common():
            f.write(f"{name}\t{count[name]}\t{ns}\n")
    d2h = {k: v for k, v in count.items()
           if "memcpy" in k.lower() and ("d2h" in k.lower() or "dtoh" in k.lower())}
    return {
        "device_ns": sum(per_op.values()), "window_ns": window,
        "busy_share": f"{busy / window:.3f}" if window else "n/a",
        "d2h_copies": sum(d2h.values()), "gpu_lines": len(lines),
        "top": ";".join(f"{k[:60]}={v / 1e6:.2f}ms/{count[k]}"
                        for k, v in per_op.most_common(top)),
    }


def phase_trace(al_se, prefix: str, seed: int, device, trace_dir: str):
    import jax

    se, _, _ = sub_batches(prefix, seed, al_se.cfg.batch_reads, 8)
    with jax.default_device(device):
        al_se.align_batch(se)  # compiled already; warms the data path
        t0 = time.perf_counter()
        with jax.profiler.trace(trace_dir):
            al_se.align_batch(se)
        wall = time.perf_counter() - t0
    log("trace", reads=len(se), traced_wall_s=f"{wall:.3f}", dir=trace_dir,
        **summarize_trace(trace_dir))


# --- phase 5: device counting --------------------------------------------


def write_saf(path: str, prefix: str, seed: int, exons: int = 4) -> int:
    """Seeded SAF of 50 genes per Mbp (5,000 genes and 20,000 features on
    100 Mbp), each with `exons` exons 100-2000bp long and 300-3000bp apart,
    spread over the genome; returns the feature count."""
    from subread_tpu.index.genome import Genome

    genome = Genome.load(prefix)
    n_genes = max(int(genome.lengths.sum()) // 20_000, 1)
    rng = np.random.default_rng(seed + 5)
    rows = ["GeneID\tChr\tStart\tEnd\tStrand"]
    for g in range(n_genes):
        c = int(rng.integers(0, len(genome.names)))
        clen = int(genome.lengths[c])
        start = int(rng.integers(1, max(clen - exons * 5000, 2)))
        strand = "+-"[int(rng.integers(0, 2))]
        for _ in range(exons):
            end = start + int(rng.integers(100, 2001))
            rows.append(f"G{g:05d}\t{genome.names[c]}\t{start}\t{end}\t{strand}")
            start = end + int(rng.integers(300, 3001))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return len(rows) - 1


def require_same_counts(a: str, b: str) -> None:
    """Two featureCounts outputs agree: every count row (the first line
    echoes the command line) and the whole .summary."""
    def rows(path):
        with open(path) as f:
            return [l for l in f if not l.startswith("#")]

    def text(path):
        with open(path) as f:
            return f.read()

    require(rows(a) == rows(b), f"counts differ: {a} vs {b}")
    require(text(a + ".summary") == text(b + ".summary"),
            f"summaries differ: {a} vs {b}")


def run_featurecounts(argv: list[str]) -> float:
    """featureCounts through its CLI; fails if --deviceCounts handed any
    input back to the host counter."""
    from subread_tpu.tools import featurecounts

    fallbacks: list[str] = []
    t0 = time.perf_counter()
    rc = featurecounts.main(argv, device_fallbacks=fallbacks)
    took = time.perf_counter() - t0
    require(rc == 0, f"featureCounts exited {rc}")
    require(not fallbacks,
            f"--deviceCounts fell back to the host counter for {fallbacks}")
    return took


def phase_count(bam: str, n_records: int, prefix: str, seed: int,
                device) -> None:
    import jax

    run = WORK / "run"
    saf = str(run / "genes.saf")
    n_feat = write_saf(saf, prefix, seed)
    base = ["-F", "SAF", "-a", saf]
    out_dev, out_host = str(run / "dev.counts"), str(run / "host.counts")
    with jax.default_device(device):
        t_cold = run_featurecounts(base + ["--deviceCounts", "-o", out_dev, bam])
        t_warm = run_featurecounts(base + ["--deviceCounts", "-o", out_dev, bam])
    t_host = run_featurecounts(base + ["-o", out_host, bam])
    require_same_counts(out_dev, out_host)
    with open(out_host + ".summary") as f:
        assigned = next(int(l.split()[1]) for l in f
                        if l.startswith("Assigned"))
    log("5-count", features=n_feat, records=n_records, assigned=assigned,
        device_cold_s=f"{t_cold:.2f}", device_warm_s=f"{t_warm:.2f}",
        device_warm_rec_per_s=f"{n_records / t_warm:.0f}",
        host_s=f"{t_host:.2f}", host_rec_per_s=f"{n_records / t_host:.0f}")


# --- four cards ----------------------------------------------------------


PROCESS_WORKER = r"""
import json, sys
import jax
from subread_tpu.parallel.distributed import init_distributed, psum_stats
coord, n, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert init_distributed(coord, num_processes=n, process_id=pid)
local = jax.local_devices()
print(json.dumps({
    "platform": local[0].platform,
    "local": [d.local_hardware_id for d in local],
    "devices": len(jax.devices()),
    "psum_local": psum_stats({"n": len(local)})["n"],
}))
"""


def phase_processes(n: int, platform: str) -> None:
    """n processes on this machine through init_distributed, each given
    its rank as LOCAL_RANK: each must hold one card of its own (distinct
    local hardware ids), all n must join, and a psum across them must
    count n local devices.  Runs before this process opens the cards."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", PROCESS_WORKER, coord, str(n), str(p)],
            cwd=HERE, env=dict(os.environ, LOCAL_RANK=str(p)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in range(n)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0,
                f"process {rank} exited {p.returncode}:\n{err[-2000:]}")
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for rank, g in enumerate(got):
        require(g["platform"] == platform and len(g["local"]) == 1
                and g["devices"] == n and g["psum_local"] == n,
                f"process {rank}: {g}")
    cards = [g["local"][0] for g in got]
    require(len(set(cards)) == n, f"processes share cards: {cards}")
    log("4cards-processes", processes=n, cards=",".join(map(str, cards)),
        wall_s=f"{time.perf_counter() - t0:.2f}")


def phase_four_cards(devs, genome_mbp: int, seed: int, n_reads: int,
                     clock: CompileClock) -> None:
    """featureCounts --deviceCounts sharded over every card (the CLI's
    multi-device path) against one card and the host counter; then one
    sharded_align_step sub-batch on a 4-card mesh against the same step
    on one card."""
    import jax
    import jax.numpy as jnp

    from subread_tpu.io.gtf import load_annotation
    from subread_tpu.parallel.mesh import make_mesh, sharded_align_step
    from subread_tpu.quant.device_count import DeviceCounter, STATUS_NAMES

    n = len(devs)
    idx = phase_index(genome_mbp, seed)
    se = phase_se(idx["prefix"], n_reads, seed, devs[0], clock)
    bam = se["bam"]
    run = WORK / "run"
    saf = str(run / "genes.saf")
    write_saf(saf, idx["prefix"], seed)
    out_dev, out_host = str(run / "dev.counts"), str(run / "host.counts")
    t_dev = run_featurecounts(["-F", "SAF", "-a", saf, "--deviceCounts",
                               "-o", out_dev, bam])
    run_featurecounts(["-F", "SAF", "-a", saf, "-o", out_host, bam])
    require_same_counts(out_dev, out_host)
    # one card: the same kernel, unsharded, on the first device
    dc = DeviceCounter(load_annotation(saf, fmt="SAF"), strand=0)
    sections = dc.sections_from_file(bam)
    with jax.default_device(devs[0]):
        c1, s1, _, ov1 = dc.count(*sections)
    cn, sn, ovn = dc.count_sharded(make_mesh(devices=devs), *sections)
    require(ov1 == 0 and ovn == 0, "section overflow")
    require(np.array_equal(c1, cn) and np.array_equal(s1, sn),
            f"{n}-card counts differ from one card")
    assigned = int(s1[STATUS_NAMES.index("Assigned")])

    al_se, _ = make_aligners(idx["prefix"], devs[0], 16384, 8192)
    se_b, _, _ = sub_batches(idx["prefix"], seed, 16384, 8)
    codes, ambig, lens, _ = al_se._pad_batch(se_b)
    with jax.default_device(devs[0]):
        one = al_se._device_align(
            jnp.asarray(codes), jnp.asarray(ambig), jnp.asarray(lens),
            al_se.d_bucket_start, al_se.d_comb, al_se.d_sub_base,
            al_se.d_sub_lo, al_se.d_genome)
    mesh = make_mesh(devices=devs)
    t0 = time.perf_counter()
    many = jax.block_until_ready(sharded_align_step(mesh, al_se)(
        codes, ambig, lens))
    t_mesh = time.perf_counter() - t0
    for k, v in many.items():
        shards = v.addressable_shards
        require(len({s.device for s in shards}) == n
                and v.sharding.device_set == set(devs),
                f"{k} is not spread over the {n} cards")
        require(all(s.data.shape[0] == v.shape[0] // n for s in shards),
                f"{k} is not split by rows over the {n} cards")
    n_eq = require_equal_results(
        {k: np.asarray(v) for k, v in many.items()},
        {k: np.asarray(v) for k, v in one.items()}, "sharded align step")
    log("4cards", cards=n, genome_mbp=genome_mbp, records=se["records"],
        assigned=assigned, counts_equal="host,1card,4cards",
        cli_device_s=f"{t_dev:.2f}", align_rows=len(lens),
        arrays_equal=n_eq, mesh_step_first_call_s=f"{t_mesh:.2f}")


# --- entry point ---------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    ap.add_argument("--genome-mbp", type=int, default=100)
    ap.add_argument("--se-reads", type=int, default=1_000_000)
    ap.add_argument("--pe-pairs", type=int, default=250_000)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--trace", metavar="DIR",
                    help="also write a profiler trace of one warm SE "
                         "sub-batch to DIR and print its device-time summary")
    args = ap.parse_args(argv)

    require_checkout()
    if args.four_cards:
        phase_processes(4, "gpu")
    devs = require_gpus(4 if args.four_cards else 1)
    if args.four_cards:
        devs = devs[:4]
    phase_device(devs)
    clock = CompileClock()
    if args.four_cards:
        phase_four_cards(devs, args.genome_mbp, args.seed,
                         min(args.se_reads, 250_000), clock)
    else:
        import jax

        gpu, cpu = devs[0], jax.devices("cpu")[0]
        idx = phase_index(args.genome_mbp, args.seed)
        aligners = make_aligners(idx["prefix"], gpu, 16384, 8192)
        log("1-index", **idx,
            device_index_genome_bytes=aligner_bytes(aligners[0]),
            peak_bytes_in_use=peak_bytes(gpu))
        se = phase_se(idx["prefix"], args.se_reads, args.seed, gpu, clock)
        phase_pe(idx["prefix"], args.pe_pairs, args.seed, gpu, clock)
        phase_equal(idx["prefix"], args.seed, gpu, cpu, aligners)
        if args.trace:
            phase_trace(aligners[0], idx["prefix"], args.seed, gpu, args.trace)
        phase_count(se["bam"], se["records"], idx["prefix"], args.seed, gpu)
        log("end", peak_bytes_in_use=peak_bytes(gpu))
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
