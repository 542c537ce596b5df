"""Test harness: the CPU backend with 8 virtual devices, so sharding and
collective tests run without an accelerator (SURVEY.md §4 implication (c))."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

REFERENCE = pathlib.Path("/root/reference")
CHR901 = REFERENCE / "test" / "chr901.fa"


@pytest.fixture(scope="session")
def chr901_genome():
    from subread_tpu.index.genome import genome_from_fasta

    if not CHR901.exists():
        pytest.skip("reference chr901.fa not available")
    return genome_from_fasta(str(CHR901))


@pytest.fixture(scope="session")
def chr901_index(chr901_genome):
    from subread_tpu.index.build import build_hash_index

    return build_hash_index(chr901_genome, index_gap=1)


@pytest.fixture()
def rng():
    # function-scoped: every test gets the same deterministic stream
    # regardless of which other tests ran before it
    return np.random.default_rng(901)
