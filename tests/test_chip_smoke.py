"""chip_smoke.py off the card.  It must refuse to run without a GPU, and
its phases (data generation, the CLI paths, the accuracy gates, the
device-count and four-device comparisons) run on the CPU backend at a
small size, with the device passed in."""

import os
import pathlib
import subprocess
import sys

import jax
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SEED = 2024


def test_smoke_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    import chip_smoke

    old = chip_smoke.WORK
    chip_smoke.WORK = tmp_path_factory.mktemp("smoke")
    yield chip_smoke
    chip_smoke.WORK = old


@pytest.fixture(scope="module")
def se_run(smoke):
    """The SE phase at 2 Mbp and 20,000 reads on the CPU device."""
    idx = smoke.phase_index(2, SEED)
    got = smoke.phase_se(idx["prefix"], 20_000, SEED, jax.devices("cpu")[0],
                         smoke.CompileClock())
    return idx, got


def test_se_phase_on_cpu(smoke, se_run):
    idx, got = se_run
    assert idx["build_s"] != "reused"
    assert got["records"] == 20_000
    assert got["accuracy"] >= smoke.SE_ACCURACY_GATE
    assert got["precision"] >= smoke.PRECISION_GATE


def test_count_phase_on_cpu(smoke, se_run, capsys):
    idx, got = se_run
    smoke.phase_count(got["bam"], got["records"], idx["prefix"], SEED,
                      jax.devices("cpu")[0])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[5-count] features=400 records=20000")


def test_four_card_phase_on_virtual_devices(smoke, se_run):
    devs = jax.devices()[:4]
    assert len(devs) == 4
    smoke.phase_four_cards(devs, 2, SEED, 4000, smoke.CompileClock())


def test_processes_phase_on_cpu(smoke, monkeypatch):
    """Two CPU processes join through init_distributed and psum, and the
    phase then refuses them: both hold the same (host) device, where on a
    GPU machine each must hold a card of its own."""
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    with pytest.raises(RuntimeError, match=r"processes share cards: \[0, 0\]"):
        smoke.phase_processes(2, "cpu")


def test_trace_phase_on_cpu(smoke, se_run, tmp_path, capsys):
    """--trace writes a profiler trace and its per-op table; the CPU
    backend has no GPU stream lines, so the table is empty here."""
    idx, _ = se_run
    cpu = jax.devices("cpu")[0]
    al_se, _ = smoke.make_aligners(idx["prefix"], cpu, 2048, 1024)
    smoke.phase_trace(al_se, idx["prefix"], SEED, cpu, str(tmp_path))
    assert (tmp_path / "ops.tsv").read_text() == "op\tcalls\tdevice_ns\n"
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[trace] reads=2048 ")
