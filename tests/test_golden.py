"""Golden-file CLI tests — the reference's cram-test equivalent
(SURVEY.md §4): fixed checked-in M5 input, byte-for-byte expected FASTA,
exercised through every backend and the real CLI entry point."""

import io as _io
import os
import subprocess
import sys

import pytest

from pbdagcon_tpu import native
from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream

DATA = os.path.join(os.path.dirname(__file__), "data")
M5 = os.path.join(DATA, "golden1.m5")
EXPECTED = open(os.path.join(DATA, "golden1.fa")).read()
CFG = dict(min_weight=6, min_length=100)


@pytest.mark.parametrize("backend,use_native", [
    ("host", False),
    ("host", True),
    ("xla", False),
    ("xla", True),
    ("blocked", True),
])
def test_golden_all_backends(backend, use_native):
    if use_native and not native.available():
        pytest.skip("native library not built")
    out = _io.StringIO()
    with open(M5) as f:
        run_stream(
            f, FastaWriter(out),
            DagconConfig(backend=backend, use_native=use_native, **CFG),
        )
    assert out.getvalue() == EXPECTED


def _golden_via_solver(solver: str) -> str:
    """Golden input through the host linearizer and one device DP
    solver (`dp._solve`)."""
    import jax.numpy as jnp
    import numpy as np

    from pbdagcon_tpu.io import read_groups
    from pbdagcon_tpu.ops.dp import DP_KEYS, _solve, choose_layout, pad_batch
    from pbdagcon_tpu.pipeline import consensus_for_lin, linearize_group

    cfg = DagconConfig(backend="xla", use_native=False, **CFG)
    with open(M5) as f:
        lins = [linearize_group(g, cfg) for g in read_groups(f, "m5")]
    V = -(-max(l.n for l in lins) // 64) * 64
    W, K = choose_layout(lins)
    b = pad_batch(lins, V, W, K)
    scores, unconv = _solve(tuple(jnp.asarray(b[k]) for k in DP_KEYS), V,
                            solver)
    assert unconv is None or not np.asarray(unconv).any()
    scores = np.asarray(scores)
    out = _io.StringIO()
    w = FastaWriter(out)
    for i, lin in enumerate(lins):
        w.write_target(lin.sid, consensus_for_lin(lin, scores[i, : lin.n], cfg))
    return out.getvalue()


@pytest.mark.parametrize("solver", ["scan", "blocked"])
def test_golden_via_solver(solver):
    """Each device DP solver, called directly on the padded batch,
    reproduces the golden FASTA."""
    assert _golden_via_solver(solver) == EXPECTED


@pytest.mark.gpu
@pytest.mark.parametrize("backend,use_native", [
    ("xla", False),
    ("xla", True),
    ("blocked", True),
    ("devbuild", True),
])
def test_golden_on_gpu(gpu, backend, use_native):
    """Every device backend on the card."""
    if use_native and not native.available():
        pytest.skip("native library not built")
    out = _io.StringIO()
    with open(M5) as f:
        run_stream(
            f, FastaWriter(out),
            DagconConfig(backend=backend, use_native=use_native, **CFG),
        )
    assert out.getvalue() == EXPECTED


def test_golden_cli_subprocess():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.dirname(DATA and os.path.dirname(DATA)))
    res = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu", M5, "-c", "6", "-m", "100",
         "--backend", "host"],
        capture_output=True, text=True, timeout=120,
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == EXPECTED


def test_shard_and_journal_cli(tmp_path, capsys):
    from pbdagcon_tpu.cli import main

    j = tmp_path / "done.journal"
    # Shard 0/2 then 1/2 must partition the golden targets.
    outs = []
    for shard in ("0/2", "1/2"):
        rc = main([M5, "-c", "6", "-m", "100", "--backend", "host",
                   "--shard", shard])
        assert rc == 0
        outs.append(capsys.readouterr().out)
    merged_headers = sorted(
        l for o in outs for l in o.splitlines() if l.startswith(">")
    )
    assert merged_headers == sorted(
        l for l in EXPECTED.splitlines() if l.startswith(">")
    )

    # Journal: first run does all targets, second run skips them.
    rc = main([M5, "-c", "6", "-m", "100", "--backend", "host",
               "--journal", str(j)])
    assert rc == 0
    assert capsys.readouterr().out == EXPECTED
    rc = main([M5, "-c", "6", "-m", "100", "--backend", "host",
               "--journal", str(j)])
    assert rc == 0
    assert capsys.readouterr().out == ""  # everything journaled


PRE = os.path.join(DATA, "golden2.pre")
EXPECTED2 = open(os.path.join(DATA, "golden2.fa")).read()


@pytest.mark.parametrize("backend,use_native,align_backend", [
    ("host", False, "host"),
    ("host", True, "host"),
    ("xla", True, "host"),
    ("xla", False, "device"),
    ("xla", True, "device"),
])
def test_golden_align_mode(backend, use_native, align_backend):
    if use_native and not native.available():
        pytest.skip("native library not built")
    out = _io.StringIO()
    with open(PRE) as f:
        run_stream(
            f, FastaWriter(out),
            DagconConfig(
                min_weight=5, min_length=80, fmt="pre", align=True,
                backend=backend, use_native=use_native,
                align_backend=align_backend,
            ),
        )
    assert out.getvalue() == EXPECTED2


def test_selfcheck_cli(capsys):
    from pbdagcon_tpu.cli import main

    rc = main([M5, "-c", "6", "-m", "100", "--selfcheck"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "4/4 targets OK" in err
