#!/usr/bin/env python3
"""End-to-end timing of the CLI backends on a BASELINE #2-shaped stream.

    python tools/e2e_stream.py --targets 2048 --rounds 5
    JAX_PLATFORMS=cpu python tools/e2e_stream.py --targets 512 --rounds 1

Generates `--targets` targets of BASELINE.json config #2's shape (1000 bp
x 30x, raw 'pre' records, -a; seed 1234), takes the 1-thread native
engine's FASTA as the reference, then runs each `--backend` through
`cli.main` in one process: `--warmup` untimed runs each, then `--rounds`
rounds with the backends in turns (order reversed every other round).
Every run must be byte-identical to the reference. Prints per backend
the seconds of each run, their quartiles, consensus bases/s at the
median and the run's host fallbacks, with the card's name and power
limit (or "cpu"). Under JAX_PLATFORMS=cpu it gives the CPU's host
fallback counts that `chip_smoke.py` holds the card to.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def quartiles(v: list[float]) -> tuple[float, float, float]:
    v = sorted(v)
    m = len(v)
    return v[m // 4], (v[(m - 1) // 2] + v[m // 2]) / 2, v[(3 * m) // 4]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--targets", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=2,
                    help="untimed runs of each backend first (the band "
                    "and V adaptation settles over the first runs)")
    ap.add_argument("--backends", nargs="+", default=["devbuild", "xla"])
    args = ap.parse_args(argv)

    import jax

    import chip_smoke as cs
    from pbdagcon_tpu import native
    from pbdagcon_tpu.config import enable_compile_cache

    card = cs.card_label() if jax.default_backend() == "gpu" else "cpu"
    print(card, flush=True)
    if not native.ensure_built():
        print("native engine failed to build", file=sys.stderr)
        return 1
    enable_compile_cache()
    t0 = time.perf_counter()
    text = cs.make_stream(args.targets)
    ref = cs.native_reference(text)
    print(f"stream: {args.targets} targets ({len(text)} bytes), native "
          f"1-thread reference {time.perf_counter() - t0:.3f}s", flush=True)

    with tempfile.TemporaryDirectory(prefix="dagcon-e2e-") as work:
        path = os.path.join(work, "stream.pre")
        with open(path, "wb") as f:
            f.write(text)
        common = [path, "-c", str(cs.MIN_COV), "-m", str(cs.MIN_LEN), "-a",
                  "--fmt", "pre"]

        def run(backend: str) -> tuple[float, int, int]:
            fa, logs, dt = cs.run_cli(common + ["--backend", backend])
            if fa != ref:
                raise cs.SmokeError(f"--backend {backend} FASTA != native")
            return (dt, cs.log_int(logs, "host_fallbacks"),
                    cs.log_int(logs, "bases"))

        for b in args.backends:
            for _ in range(args.warmup):
                dt, fb, _ = run(b)
                print(f"warm-up --backend {b}: {dt:.3f}s "
                      f"host_fallbacks={fb}", flush=True)
        times: dict[str, list[float]] = {b: [] for b in args.backends}
        info: dict[str, tuple[int, int]] = {}
        for r in range(args.rounds):
            order = args.backends if r % 2 == 0 else args.backends[::-1]
            for b in order:
                dt, fb, bases = run(b)
                times[b].append(dt)
                info[b] = (fb, bases)
    for b, v in times.items():
        lo, med, hi = quartiles(v)
        fb, bases = info[b]
        print(
            f"e2e --backend {b} ({card}): runs={[round(x, 3) for x in v]} "
            f"q1={lo:.3f} median={med:.3f} q3={hi:.3f}s "
            f"bases={bases} ({bases / med:.0f} bases/s) host_fallbacks={fb}",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
