"""Multi-process distributed exercise (SURVEY.md §4 test plan): two
`jax.distributed` CPU processes run `--distributed --journal` over the
same input; each takes its round-robin manifest shard, and the merged
FASTA must equal the single-process run. This is the CPU simulation of
the multi-host pod mode (north star: N>=2 hosts)."""

import io as _io
import os
import subprocess
import sys
import time

import pytest

from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream
from pbdagcon_tpu.simulate import simulate_targets, to_m5


def _mk_input(path: str, n_targets: int = 6) -> None:
    with open(path, "w") as f:
        for tid, _bb, alns in simulate_targets(333, n_targets, 250, 10):
            for a in alns:
                f.write(to_m5(a) + "\n")


@pytest.mark.skipif(
    os.environ.get("DAGCON_SKIP_MULTIPROC") == "1",
    reason="multi-process test disabled",
)
def test_two_process_distributed_matches_single(tmp_path):
    _run_two_process(tmp_path, backend="host")


@pytest.mark.skipif(
    os.environ.get("DAGCON_SKIP_MULTIPROC") == "1",
    reason="multi-process test disabled",
)
def test_two_process_distributed_device_dp(tmp_path):
    """VERDICT r2 #7: the multi-process path must also hold with a
    device-DP backend — each rank batches its shard through the xla DP
    (CPU devices here), exercising journal + sharding + device dispatch
    together."""
    _run_two_process(tmp_path, backend="xla")


def _run_two_process(tmp_path, backend: str):
    inp = str(tmp_path / "pile.m5")
    _mk_input(inp)

    # single-process reference
    with open(inp) as f:
        buf = _io.StringIO()
        run_stream(
            f, FastaWriter(buf),
            DagconConfig(min_weight=3, min_length=50, backend=backend),
        )
    single = buf.getvalue()

    # two coordinated processes, each writing its shard
    port = 12000 + (os.getpid() % 20000)
    procs = []
    outs = [str(tmp_path / f"out{i}.fa") for i in range(2)]
    for rank in range(2):
        env = dict(os.environ)
        env.update(
            PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            JAX_PLATFORMS="cpu",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(rank),
        )
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "pbdagcon_tpu", inp,
                    "-c", "3", "-m", "50", "--backend", backend,
                    "--distributed",
                    "--journal", str(tmp_path / f"journal{rank}.txt"),
                ],
                stdout=open(outs[rank], "w"),
                stderr=subprocess.PIPE,
                env=env,
            )
        )
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail("distributed process hung")
        errs.append(err.decode())
        assert p.returncode == 0, errs[-1]

    # merge: round-robin shards preserve per-shard order; interleave by
    # target to reconstruct global input order.
    def targets_of(path):
        recs = []
        with open(path) as f:
            cur = None
            for line in f:
                if line.startswith(">"):
                    sid = line[1:].rsplit("/", 1)[0]
                    cur = (sid, [line])
                    recs.append(cur)
                else:
                    cur[1].append(line)
        return recs

    t0, t1 = targets_of(outs[0]), targets_of(outs[1])
    merged = []
    i = j = 0
    while i < len(t0) or j < len(t1):
        if i < len(t0):
            merged.extend(t0[i][1])
            i += 1
        if j < len(t1):
            merged.extend(t1[j][1])
            j += 1
    assert "".join(merged) == single
    # journals recorded each shard's targets
    j0 = open(tmp_path / "journal0.txt").read().splitlines()
    j1 = open(tmp_path / "journal1.txt").read().splitlines()
    assert len(j0) + len(j1) == 6
    assert not set(j0) & set(j1)
