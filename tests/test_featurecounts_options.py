"""Unit tests for the long-tail featureCounts options added for parity
with readSummary.c: --readShiftSize/Type, --nonOverlap(Feature),
--fracOverlapFeature, --extraAttributes, --byReadGroup, -R CORE details,
per-input -s lists, -L, and the jcounts PrimaryGene/strand columns.
Synthetic fixtures; no JAX."""

import pathlib

import pytest

from subread_tpu.io.gtf import load_annotation
from subread_tpu.quant.featurecounts import FCOptions, FeatureCounter


SAF = """GeneID\tChr\tStart\tEnd\tStrand
geneA\tchr1\t1001\t1100\t+
geneB\tchr1\t2001\t2200\t+
"""

GTF = (
    'chr1\tx\texon\t1001\t1100\t.\t+\t.\t'
    'gene_id "geneA"; gene_name "Alpha"; tier "1";\n'
    'chr1\tx\texon\t2001\t2200\t.\t+\t.\t'
    'gene_id "geneB"; gene_name "Beta";\n'
)


def sam_line(qname, flag, pos, cigar="50M", chro="chr1", mapq=30, tags=()):
    return "\t".join(
        [qname, str(flag), chro, str(pos), str(mapq), cigar, "*", "0", "0",
         "A" * 50, "I" * 50, *tags]
    )


def write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def count(tmp_path, sam_lines, opts, anno_text=SAF, fmt="SAF", **ann_kw):
    ann = load_annotation(
        write(tmp_path, "anno", anno_text), fmt=fmt, **ann_kw
    )
    fc = FeatureCounter(ann, opts)
    sam = write(tmp_path, "in.sam", "\n".join(sam_lines) + "\n")
    return fc, sam


def test_read_shift_moves_read_off_feature(tmp_path):
    # read at 1051..1100 (inside geneA); shifting right by 200 puts it in
    # the gap between the genes -> NoFeatures
    lines = [sam_line("r1", 0, 1051)]
    fc, sam = count(tmp_path, lines, FCOptions())
    fc.count_sam(sam)
    assert fc.counts[0] == 1

    fc2, sam = count(
        tmp_path, lines,
        FCOptions(read_shift_size=200, read_shift_type="right"),
    )
    fc2.count_sam(sam)
    assert fc2.counts[0] == 0
    assert fc2.summary["Unassigned_NoFeatures"] == 1


def test_read_shift_upstream_respects_strand(tmp_path):
    # reverse-strand read: upstream = larger coordinates
    lines = [sam_line("r1", 16, 1951)]  # 1951..2000, just left of geneB
    fc, sam = count(
        tmp_path, lines,
        FCOptions(read_shift_size=50, read_shift_type="upstream"),
    )
    fc.count_sam(sam)
    assert fc.counts[1] == 1  # shifted right into geneB


def test_non_overlap_read_gate(tmp_path):
    # read 981..1030: 30 bases inside geneA, 20 outside
    lines = [sam_line("r1", 0, 981)]
    fc, sam = count(tmp_path, lines, FCOptions(non_overlap=25))
    fc.count_sam(sam)
    assert fc.counts[0] == 1  # 20 missing <= 25 allowed

    fc2, sam = count(tmp_path, lines, FCOptions(non_overlap=10))
    fc2.count_sam(sam)
    assert fc2.counts[0] == 0
    assert fc2.summary["Unassigned_Overlapping_Length"] == 1


def test_non_overlap_feature_gate(tmp_path):
    # geneA span = 100; a 50M read covers 50 -> 50 missing in feature
    lines = [sam_line("r1", 0, 1001)]
    fc, sam = count(tmp_path, lines, FCOptions(non_overlap_feature=60))
    fc.count_sam(sam)
    assert fc.counts[0] == 1

    fc2, sam = count(tmp_path, lines, FCOptions(non_overlap_feature=40))
    fc2.count_sam(sam)
    assert fc2.counts[0] == 0
    assert fc2.summary["Unassigned_NoFeatures"] == 1


def test_frac_overlap_feature_gate(tmp_path):
    lines = [sam_line("r1", 0, 1001)]  # covers 50/100 of geneA
    fc, sam = count(tmp_path, lines, FCOptions(frac_overlap_feature=0.4))
    fc.count_sam(sam)
    assert fc.counts[0] == 1

    fc2, sam = count(tmp_path, lines, FCOptions(frac_overlap_feature=0.6))
    fc2.count_sam(sam)
    assert fc2.counts[0] == 0


def test_extra_attributes_columns(tmp_path):
    ann = load_annotation(
        write(tmp_path, "a.gtf", GTF), fmt="GTF",
        extra_attrs=["gene_name", "tier"],
    )
    assert ann.extra_attr_names == ["gene_name", "tier"]
    fc = FeatureCounter(ann, FCOptions())
    out = tmp_path / "out"
    fc.write_counts(str(out), ["in.sam"])
    lines = out.read_text().splitlines()
    assert lines[1].split("\t")[6:8] == ["gene_name", "tier"]
    rows = {l.split("\t")[0]: l.split("\t") for l in lines[2:]}
    assert rows["geneA"][6:8] == ["Alpha", "1"]
    assert rows["geneB"][6:8] == ["Beta", "NA"]


def test_by_read_group(tmp_path):
    lines = [
        sam_line("r1", 0, 1001, tags=["RG:Z:s1"]),
        sam_line("r2", 0, 1001, tags=["RG:Z:s2"]),
        sam_line("r3", 0, 2001, tags=["RG:Z:s2"]),
    ]
    fc, sam = count(tmp_path, lines, FCOptions(by_read_group=True))
    fc.count_sam(sam)
    assert sorted(fc.rg_tables) == ["s1", "s2"]
    assert fc.rg_tables["s1"][0][0] == 1
    assert fc.rg_tables["s2"][0].tolist() == [1, 1]
    out = tmp_path / "out"
    fc.write_counts(str(out), ["in.sam"])
    hdr = out.read_text().splitlines()[1].split("\t")
    assert hdr[-2:] == ["in.sam:s1", "in.sam:s2"]
    fc.write_summary(str(out) + ".summary", ["in.sam"])
    smry = (tmp_path / "out.summary").read_text().splitlines()
    assert smry[0].split("\t") == ["Status", "in.sam:s1", "in.sam:s2"]
    assert smry[1].split("\t") == ["Assigned", "1", "2"]


def test_detail_core_format(tmp_path):
    lines = [
        sam_line("hit", 0, 1001),
        sam_line("miss", 0, 1500),
        sam_line("unmapped", 4, 0, cigar="*"),
    ]
    fc, sam = count(tmp_path, lines, FCOptions())
    detail = tmp_path / "in.sam.featureCounts"
    fc.open_details(str(detail), "CORE")
    fc.count_sam(sam)
    fc.close_details()
    got = dict(
        (l.split("\t")[0], l.split("\t")[1:])
        for l in detail.read_text().splitlines()
    )
    assert got["hit"] == ["Assigned", "1", "geneA"]
    assert got["miss"] == ["Unassigned_NoFeatures", "-1", "NA"]
    assert got["unmapped"] == ["Unassigned_Unmapped", "0", "NA"]


def test_long_reads_no_mop_cap(tmp_path):
    # 12 alternating 5M5N segments exceed the default maxMOp=10
    cigar = "5M5N" * 11 + "5M"
    lines = [sam_line("lr", 0, 1001, cigar=cigar)]
    fc, sam = count(tmp_path, lines, FCOptions(long_reads=True))
    fc.count_sam(sam)
    assert fc.counts[0] == 1


def test_jcounts_primary_gene_and_strand(tmp_path):
    genome = tmp_path / "g.fa"
    seq = ["A"] * 3000
    # donor GT at 1101-1102, acceptor AG at 1999-2000 (1-based)
    seq[1100:1102] = ["G", "T"]
    seq[1998:2000] = ["A", "G"]
    genome.write_text(">chr1\n" + "".join(seq) + "\n")
    # junction read: 50M900N50M starting at 1051 -> sites (1100, 2001)
    lines = [sam_line("jr", 0, 1051, cigar="50M900N50M")]
    fc, sam = count(tmp_path, lines, FCOptions(count_junctions=True))
    fc.count_sam(sam)
    out = tmp_path / "out.jcounts"
    fc.write_jcounts(str(out), ["in.sam"], genome=str(genome))
    row = out.read_text().splitlines()[1].split("\t")
    assert row[0] == "geneA"          # PrimaryGene: site1 is in geneA
    assert row[1] == "geneB"          # SecondaryGenes: site2 in geneB
    assert row[2:5] == ["chr1", "1100", "+"]
    assert row[5:8] == ["chr1", "2001", "+"]


def test_summary_nonsplit_label(tmp_path):
    lines = [sam_line("r1", 0, 1001, cigar="25M10N25M")]
    fc, sam = count(tmp_path, lines, FCOptions(non_split_only=True))
    fc.count_sam(sam)
    out = tmp_path / "s"
    fc.write_summary(str(out), ["in.sam"])
    text = out.read_text()
    assert "Unassigned_Split\t1" in text
    assert "Unassigned_NonSplit" not in text

    fc2, sam = count(tmp_path, lines, FCOptions(split_only=True))
    fc2.count_sam(sam)
    fc2.write_summary(str(out), ["in.sam"])
    assert "Unassigned_NonSplit\t0" in out.read_text()


def test_cli_strand_list_and_flags(tmp_path):
    from subread_tpu.tools.featurecounts import main

    anno = write(tmp_path, "a.saf", SAF)
    sam1 = write(tmp_path, "f1.sam", sam_line("r1", 0, 1001) + "\n")
    sam2 = write(tmp_path, "f2.sam", sam_line("r2", 16, 1001) + "\n")
    out = tmp_path / "o"
    # -s 1,2: file1 stranded fwd (assigned), file2 reverse (read on -,
    # feature on + -> reverse mode assigns it)
    assert main([
        "-a", anno, "-F", "SAF", "-o", str(out), "-s", "1,2",
        sam1, sam2,
    ]) == 0
    rows = {
        l.split("\t")[0]: l.split("\t")
        for l in out.read_text().splitlines()[2:]
    }
    assert float(rows["geneA"][6]) == 2.0


def test_detection_call_gc_column(tmp_path):
    """--detectionCall echoes the SAF 6th column as a GCfraction column
    (fixture = reference binary run with --detectionCall on gc.SAF)."""
    import pathlib

    from subread_tpu.tools.featurecounts import main

    here = pathlib.Path(__file__).parent / "data" / "fc_flags"
    sam = "/root/reference/test/featureCounts/data/test-minimum.sam"
    if not pathlib.Path(sam).exists():
        pytest.skip("reference test-minimum.sam not available")
    out = tmp_path / "gc.FC"
    assert main([
        "-p", "--countReadPairs", "--detectionCall", "-F", "SAF",
        "-a", str(here / "gc.SAF"), "-o", str(out), sam,
    ]) == 0
    ours = out.read_text().splitlines()[1:]
    ref = (here / "gc.ref.FC").read_text().splitlines()[1:]
    assert ours == ref
    assert (out.parent / "gc.FC.summary").read_text() \
        == (here / "gc.ref.FC.summary").read_text()


def _synthetic_pe(tmp_path, n_pairs=3000, seed=7):
    """Seeded PE SAM + BAM (name-adjacent mates: proper pairs over spliced,
    indel and clipped CIGARs, mates unmapped, chimeric pairs) and a SAF of
    overlapping genes on both strands."""
    import numpy as np

    from subread_tpu.io import sam as samio

    rng = np.random.default_rng(seed)
    chroms = {"chr1": 200_000, "chr2": 150_000}
    names = list(chroms)
    saf = ["GeneID\tChr\tStart\tEnd\tStrand"]
    for g in range(60):
        c = names[g % 2]
        start = int(rng.integers(1, chroms[c] - 6000))
        strand = "+-"[int(rng.integers(2))]
        for _ in range(int(rng.integers(1, 4))):
            end = start + int(rng.integers(100, 1500))
            saf.append(f"G{g:02d}\t{c}\t{start}\t{end}\t{strand}")
            start = end + int(rng.integers(50, 800))
    cigars = ["100M", "40M300N60M", "60M2D40M", "30M1I69M", "10S90M"]
    lines = [f"@SQ\tSN:{c}\tLN:{n}" for c, n in chroms.items()]
    for i in range(n_pairs):
        c1 = names[int(rng.integers(2))]
        p1 = int(rng.integers(1, chroms[c1] - 1000))
        frag = int(rng.integers(150, 600))
        c2, p2 = c1, p1 + frag - 100
        rev = bool(rng.integers(2))
        f1 = 0x1 | 0x2 | 0x40 | (0x10 if rev else 0x20)
        f2 = 0x1 | 0x2 | 0x80 | (0x20 if rev else 0x10)
        kind = rng.random()
        if kind < 0.05:    # mate 2 unmapped
            f1, f2 = (f1 & ~0x2) | 0x8, (f2 & ~0x2) | 0x4
        elif kind < 0.08:  # chimeric: mate 2 on the other chromosome
            c2 = names[1 - names.index(c1)]
            p2 = int(rng.integers(1, chroms[c2] - 1000))
            f1, f2 = f1 & ~0x2, f2 & ~0x2
        cig = [cigars[int(rng.integers(len(cigars)))] for _ in range(2)]
        mq = int(rng.integers(0, 61))
        for flag, c, p, mc, mp, cg, tl in (
            (f1, c1, p1, c2, p2, cig[0], frag),
            (f2, c2, p2, c1, p1, cig[1], -frag),
        ):
            unmapped = flag & 0x4
            lines.append("\t".join([
                f"p{i:05d}", str(flag), c, str(p), "0" if unmapped else str(mq),
                "*" if unmapped else cg, "=" if mc == c else mc, str(mp),
                str(tl if c1 == c2 else 0), "*", "*",
            ]))
    saf_path = tmp_path / "genes.SAF"
    saf_path.write_text("\n".join(saf) + "\n")
    sam_path = tmp_path / "pe.sam"
    sam_path.write_text("\n".join(lines) + "\n")
    bam_path = str(tmp_path / "pe.bam")
    w = samio.make_writer(bam_path, names, list(chroms.values()),
                          sam_output=False)
    for line in lines:
        if not line.startswith("@"):
            w.write_line(line)
    w.close()
    return str(saf_path), [str(sam_path), bam_path]


def test_native_pe_matches_python(tmp_path):
    """The native PE fast path (fc_count_sam_pe / fc_count_bam_pe) and the
    python engine produce identical counts and summaries."""
    import numpy as np

    from subread_tpu.io.gtf import load_annotation
    from subread_tpu.quant.featurecounts import FCOptions, FeatureCounter

    saf, inputs = _synthetic_pe(tmp_path)
    ann = load_annotation(saf, fmt="SAF")
    for path in inputs:
        for strand in (0, 1, 2):
            opts = FCOptions(paired=True, count_read_pairs=True,
                             strand=strand)
            a = FeatureCounter(ann, opts)
            assert a._native_eligible()
            a.count_file(path)
            b = FeatureCounter(ann, opts)
            b._native_eligible = lambda: False
            b.count_file(path)
            assert a.counts.sum() > 0
            assert np.array_equal(a.counts, b.counts), (path, strand)
            assert a.summary == b.summary, (path, strand)


def test_orphan_spill_pairing_matches_unbounded(tmp_path):
    """Bounded-memory mate pairing: a name-scattered PE SAM whose pending
    orphans exceed the budget spills to qname-hashed disk buckets and is
    paired in merge rounds (SAM_pairer disk spill, input-files.c:5672);
    counts and summary must equal the unbounded in-RAM pairing."""
    n = 500
    # all first mates, then all second mates reversed: pending peaks at n
    lines = [sam_line(f"p{i}", 0x1 | 0x40 | (0x20 if i % 2 else 0),
                      1001 + (i % 90))
             for i in range(n)]
    lines += [sam_line(f"p{i}", 0x1 | 0x80 | (0x10 if i % 2 else 0),
                       2001 + (i % 150))
              for i in reversed(range(n))]
    # a few true orphans (mate never appears)
    lines += [sam_line(f"orph{j}", 0x1 | 0x40, 1001) for j in range(3)]

    fc1, sam = count(tmp_path, lines, FCOptions(paired=True))
    fc1._native_eligible = lambda: False
    fc1.count_sam(sam)

    fc2, sam = count(tmp_path, lines, FCOptions(paired=True))
    fc2._native_eligible = lambda: False
    fc2.count_sam(sam, orphan_budget=16)

    assert fc1.counts.tolist() == fc2.counts.tolist()
    assert dict(fc1.summary) == dict(fc2.summary)
    assert fc1.counts.sum() > 0
