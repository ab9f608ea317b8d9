"""High-depth benchmark (BASELINE config #3: 100-500x coverage): device
paths vs the single-core host engine, parity-checked.

    python tools/bench_highdepth.py [cov] [n_targets] [L]
"""
import io as _io
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main() -> int:
    cov = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    n_targets = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    length = int(sys.argv[3]) if len(sys.argv) > 3 else 1000

    from pbdagcon_tpu import native
    from pbdagcon_tpu.config import DagconConfig
    from pbdagcon_tpu.io import FastaWriter
    from pbdagcon_tpu.pipeline import run_stream
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_m5

    # gapped M5 records, align=False: BASELINE config #3 stresses the
    # merge/vote engine itself, not the re-aligner. Default noise: the
    # gap-heavy profile at 200x+ exceeds the 14-bit per-target node cap
    # (ins-count ~ L*cov*ins_rate > ND 16383) and the devbuild path
    # legitimately host-falls-back wholesale (recorded limitation).
    noise = NoiseProfile()
    lines = []
    for _tid, _bb, alns in simulate_targets(
        4321, n_targets, length, cov, noise
    ):
        lines.extend(to_m5(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()
    print(
        f"highdepth: {n_targets} targets x {length}bp x {cov}x "
        f"({len(text)/1e6:.0f} MB)", file=sys.stderr,
    )
    mw = max(2, cov // 4)
    assert native.ensure_built()

    def run(backend, threads=4, reps=1, align_backend="host"):
        best = None
        fa = None
        for _ in range(reps):
            buf = _io.StringIO()
            cfg = DagconConfig(
                fmt="m5", align=False, min_weight=mw, min_length=100,
                backend=backend, use_native=True, threads=threads,
                align_backend=align_backend,
            )
            t0 = time.time()
            run_stream(_io.BytesIO(text), FastaWriter(buf), cfg)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
            fa = buf.getvalue()
        bases = sum(
            len(l) for l in fa.splitlines() if not l.startswith(">")
        )
        return fa, bases, best

    fa_h, bases, t_h = run("host", threads=1)
    print(
        f"highdepth: host 1-core {bases/t_h:,.0f} b/s ({t_h:.1f}s, "
        f"{bases} bases)", file=sys.stderr,
    )
    for backend, ab in (("xla", "host"), ("devbuild", "host")):
        try:
            fa_d, bases_d, t_d = run(backend, reps=2, align_backend=ab)
            parity = "OK" if fa_d == fa_h else "MISMATCH"
            print(
                f"highdepth: {backend}+{ab}-align {bases_d/t_d:,.0f} b/s "
                f"({t_d:.1f}s) vs 1-core = {t_h/t_d:.2f}x parity={parity}",
                file=sys.stderr,
            )
            if parity != "OK":
                return 1
        except Exception as e:
            print(f"highdepth: {backend} failed: {e}", file=sys.stderr)
    return 0





def exec_only(cov=200, n_targets=128, length=1000):
    """Chip-resident devbuild step rate at depth (same chained-steps
    accounting as bench.py's devbuild_execute metric)."""
    import jax as _jx
    import jax.numpy as jnp

    from pbdagcon_tpu import native
    from pbdagcon_tpu.devpipe import (
        DevCapsConfig, _B_LADDER, _C_LADDER, _L_LADDER, _R_LADDER,
        _ladder, caps_for, ins_cap,
    )
    from pbdagcon_tpu.ops import devemit
    from pbdagcon_tpu.ops.devbuild_jax import device_build
    from pbdagcon_tpu.ops.dp import dp_scores
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_m5

    noise = NoiseProfile()
    lines = []
    for _tid, _bb, alns in simulate_targets(
        4321, n_targets, length, cov, noise
    ):
        lines.extend(to_m5(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()
    mw = max(2, cov // 4)
    assert native.ensure_built()
    with native.NativeEngine(
        min_weight=mw, min_length=100, threads=4, align=False
    ) as eng:
        count = eng.encode_text(text, fmt="m5", flush=True)
        metas = eng.enc_metas(count)
        tot_ins = int(metas[:, 3].sum())
        tot_cols = int(metas[:, 4].sum())
        dcap = (
            DevCapsConfig.compact()
            if tot_ins <= 0.11 * max(1, tot_cols)
            else DevCapsConfig.heavy()
        )
        Rb = _ladder(int(metas[:, 0].max()), _R_LADDER)
        Cb = _ladder(int(metas[:, 1].max()), _C_LADDER)
        b_fit = _ladder(count, _B_LADDER) or _B_LADDER[-1]
        while b_fit > _B_LADDER[0] and b_fit * Rb * Cb > (1 << 26):
            b_fit = _B_LADDER[_B_LADDER.index(b_fit) - 1]
        caps = caps_for(
            b_fit, Rb, Cb,
            _ladder(int(metas[:, 2].max()), _L_LADDER), dcap,
            ch_need=int(metas[:, 5].max()),
            sm_need=int(metas[:, 6].max()),
            nd_need=int(metas[:, 3].max()),
            dq_need=int(metas[:, 7].max()),
            se_need=int(metas[:, 8].max()),
            w_need=64,
        )
        print(f"highdepth exec: caps={caps}", file=sys.stderr)
        NI = ins_cap(caps)
        part = [i for i in range(count) if int(metas[i, 3]) <= NI][: caps.B]
        arrs = eng.enc_fill(part, caps.R, caps.C, caps.L, NI, B=caps.B)
        dev_in = tuple(_jx.device_put(np.asarray(a)) for a in arrs)
        np.asarray(dev_in[4])
        Pw = min(caps.V, 2 * caps.L + 64)
        KREP = 3

        @_jx.jit
        def _exec_chain(ops_, starts_, bbuf_, ins_, Lr_):
            tot = jnp.int32(0)
            o = ops_
            for _ in range(KREP):
                b = device_build(o, starts_, bbuf_, ins_, Lr_, caps)
                s = dp_scores(
                    b["win"], b["exit_cnt"], b["cov"], b["unsup"],
                    b["long_u"], b["long_w"], b["long_esc"],
                )
                e = devemit.backtrack_emit(b, s, jnp.int32(mw), Pw)
                pl = jnp.sum(e["path_len"]).astype(jnp.int32)
                tot = tot + pl
                o = o ^ jnp.equal(pl, -1234567).astype(o.dtype)
            return tot

        nfb = 0
        int(_exec_chain(*dev_in))
        t0 = time.time()
        int(_exec_chain(*dev_in))
        dt = time.time() - t0
        rate = len(part) * length * KREP / dt
        print(
            f"highdepth exec-only {cov}x: {rate:,.0f} b/s "
            f"({len(part)} targets, {KREP} steps, {dt:.2f}s)",
            file=sys.stderr,
        )
    return rate


if __name__ == "__main__":
    if "exec" in sys.argv:
        sys.argv.remove("exec")
        cov = int(sys.argv[1]) if len(sys.argv) > 1 else 200
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 128
        L = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
        exec_only(cov, n, L)
        raise SystemExit(0)
    raise SystemExit(main())
