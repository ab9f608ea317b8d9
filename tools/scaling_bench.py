"""Multi-process distributed scaling measurement (CPU simulation).

Runs the same workload through 1 process and through N coordinated
`jax.distributed` processes (round-robin manifest shards, the --distributed
path), with the SAME per-process thread budget, and reports throughput and
scaling efficiency. This is the single-box stand-in for the multi-host
measurement (north star: >=80% at N>=2 hosts); re-run on real separate
hosts when available.

    python tools/scaling_bench.py [n_targets] [len] [cov] [nproc] [threads]
"""
import json
import os
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def run_procs(inp, nproc, threads, outdir):
    port = 13000 + (os.getpid() % 20000)
    procs = []
    outs = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(
            PYTHONPATH=_ROOT,
            JAX_PLATFORMS="cpu",
        )
        cmd = [
            sys.executable, "-m", "pbdagcon_tpu", inp,
            "-c", "4", "-m", "100", "--backend", "host",
            "-j", str(threads),
        ]
        if nproc > 1:
            env.update(
                JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                JAX_NUM_PROCESSES=str(nproc),
                JAX_PROCESS_ID=str(rank),
            )
            cmd.append("--distributed")
            if os.environ.get("SCALING_SHARD_BYTES", "1") == "1":
                # byte-range input split: each rank parses only ~1/N
                # of the file (removes the parse-replication floor)
                cmd.append("--shard-bytes")
        out = os.path.join(outdir, f"out{nproc}_{rank}.fa")
        outs.append(out)
        procs.append(
            subprocess.Popen(
                cmd, stdout=open(out, "w"), stderr=subprocess.PIPE, env=env
            )
        )
    ranks = []  # per-rank (wall, cpu) — the 4-proc forensics
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-2000:]
        # per-process processing time (excludes interpreter + jax
        # bring-up, which a long-running service pays once)
        for ln in err.decode().splitlines():
            if ln.startswith("proc_time="):
                fields = dict(
                    kv.split("=") for kv in ln.split() if "=" in kv
                )
                ranks.append(
                    (
                        float(fields["proc_time"].rstrip("s")),
                        float(fields.get("cpu_time", "0s").rstrip("s")),
                    )
                )
    assert ranks, "no proc_time line on stderr"
    dt = max(w for w, _c in ranks)
    recs = []
    for o in outs:
        recs.extend(">" + r for r in open(o).read().split(">") if r)
    return dt, "".join(sorted(recs)), ranks


def main() -> int:
    n_targets = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    length = int(sys.argv[2]) if len(sys.argv) > 2 else 500
    cov = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    nproc = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    threads = int(sys.argv[5]) if len(sys.argv) > 5 else 2

    from pbdagcon_tpu.simulate import write_m5

    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "pile.m5")
        write_m5(
            inp, seed=777, n_targets=n_targets, backbone_len=length,
            coverage=cov,
        )
        # warmup (imports, page cache)
        run_procs(inp, 1, threads, d)
        t1 = min(run_procs(inp, 1, threads, d)[0] for _ in range(2))
        dtn, fasta_n, ranks = run_procs(inp, nproc, threads, d)
        dtn2, _f2, ranks2 = run_procs(inp, nproc, threads, d)
        if dtn2 < dtn:
            dtn, ranks = dtn2, ranks2
        _, fasta_1, _r1 = run_procs(inp, 1, threads, d)
        # shard-merge must equal the single-process output (both sorted
        # per record since shard interleaving reorders targets)
        assert fasta_n == fasta_1, "distributed merge differs from single"
        eff = (t1 / dtn) / nproc
        # Per-rank forensics (VERDICT r2 #7): cpu ~= wall * threads on
        # every rank means the efficiency loss is core contention on
        # this shared box, not a serialization in the code; a rank with
        # cpu << wall would indicate waiting (skewed shard / barrier).
        per_rank = [
            {"wall_s": round(w, 2), "cpu_s": round(c, 2),
             "cpu_over_wall": round(c / w, 2) if w else 0.0}
            for w, c in ranks
        ]
        print(
            json.dumps(
                {
                    "metric": "distributed_scaling_efficiency",
                    "n_processes": nproc,
                    "threads_per_process": threads,
                    "targets": n_targets,
                    "t_1proc_s": round(t1, 2),
                    f"t_{nproc}proc_s": round(dtn, 2),
                    "speedup": round(t1 / dtn, 3),
                    "efficiency": round(eff, 3),
                    "per_rank": per_rank,
                    "parity": "merged shards == single-process FASTA",
                }
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
