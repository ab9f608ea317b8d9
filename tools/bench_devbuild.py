"""End-to-end devbuild throughput on the attached chip.

    python tools/bench_devbuild.py [n_targets] [len] [cov]
"""
import io
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main() -> int:
    n_targets = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    length = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    cov = int(sys.argv[3]) if len(sys.argv) > 3 else 30

    import jax

    from pbdagcon_tpu.config import enable_compile_cache

    enable_compile_cache()
    print(f"platform={jax.devices()[0].platform}", file=sys.stderr)

    from pbdagcon_tpu import native
    from pbdagcon_tpu.config import DagconConfig
    from pbdagcon_tpu.io import FastaWriter
    from pbdagcon_tpu.pipeline import PipelineStats, run_stream
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

    assert native.ensure_built()
    lines = []
    for _tid, _bb, alns in simulate_targets(
        1234, n_targets, length, cov, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()

    cfg = DagconConfig(
        min_weight=max(2, cov // 4), min_length=100,
        threads=os.cpu_count() or 4, backend="devbuild", fmt="pre",
        align=True, batch_targets=512,
    )

    def run():
        out = io.StringIO()
        stats = PipelineStats()
        t = time.time()
        stats = run_stream(
            io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg
        )
        dt = time.time() - t
        fasta = out.getvalue()
        bases = sum(
            len(l) for l in fasta.splitlines() if not l.startswith(">")
        )
        return dt, bases, stats, fasta

    t0 = time.time()
    _dt, _b, stats, _f = run()
    print(
        f"warmup {time.time()-t0:.1f}s (fallbacks="
        f"{stats.host_fallbacks}/{stats.targets})",
        file=sys.stderr,
    )
    best = None
    for rep in range(3):
        dt, bases, stats, fasta = run()
        print(f"run {rep}: {dt:.2f}s  {bases/dt:,.0f} b/s", file=sys.stderr)
        best = dt if best is None else min(best, dt)
    # host single-core anchor
    with native.NativeEngine(
        min_weight=cfg.min_weight, min_length=cfg.min_length, threads=1,
        align=True,
    ) as eng:
        t = time.time()
        fasta_host = eng.consensus_text(text, fmt="pre")
        hdt = time.time() - t
    parity = "OK" if fasta == fasta_host else "MISMATCH"
    print(
        f"devbuild {bases/best:,.0f} b/s | host-1core {bases/hdt:,.0f} b/s "
        f"| parity {parity} | fallbacks {stats.host_fallbacks}/{stats.targets}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
