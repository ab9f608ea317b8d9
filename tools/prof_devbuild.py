"""Stage-level device profile of the devbuild path on the bench workload.

Times each stage with an explicit tiny fetch to synchronize (async
dispatch alone would time the enqueue). Run on the accelerator:

    python tools/prof_devbuild.py [n_targets] [cov]
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main() -> int:
    n_targets = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    cov = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    length = 1000

    import jax
    import jax.numpy as jnp

    from pbdagcon_tpu import native
    from pbdagcon_tpu.devpipe import (
        DevCapsConfig,
        _B_LADDER,
        _C_LADDER,
        _L_LADDER,
        _R_LADDER,
        _ladder,
        caps_for,
        ins_cap,
    )
    from pbdagcon_tpu.ops import devemit
    from pbdagcon_tpu.ops.devbuild_jax import device_build
    from pbdagcon_tpu.ops.dp import dp_scores
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

    print(f"platform={jax.devices()[0].platform}", file=sys.stderr)
    assert native.ensure_built()

    lines = []
    for _tid, _bb, alns in simulate_targets(
        1234, n_targets, length, cov, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()

    eng = native.NativeEngine(
        min_weight=max(2, cov // 4), min_length=100, threads=4, align=True
    )
    t0 = time.time()
    count = eng.encode_text(text, fmt="pre", flush=True)
    t_enc = time.time() - t0
    metas = eng.enc_metas(count)
    tot_ins = int(metas[:, 3].sum())
    tot_cols = int(metas[:, 4].sum())
    dcfg = (
        DevCapsConfig.compact()
        if tot_ins <= 0.11 * max(1, tot_cols)
        else DevCapsConfig.heavy()
    )
    profile = "compact" if dcfg.W == 64 else "heavy"
    Rb = _ladder(int(metas[:, 0].max()), _R_LADDER)
    Cb = _ladder(int(metas[:, 1].max()), _C_LADDER)
    Lb = _ladder(int(metas[:, 2].max()), _L_LADDER)
    idxs = list(range(count))
    caps = caps_for(
        _ladder(len(idxs), _B_LADDER) or _B_LADDER[-1], Rb, Cb, Lb, dcfg,
        ch_need=int(metas[:, 5].max()),
        sm_need=int(metas[:, 6].max()),
        nd_need=int(metas[:, 3].max()),
    )
    NI = ins_cap(caps)
    idxs = [i for i in idxs if int(metas[i, 3]) <= NI]
    part = idxs[: caps.B]
    print(
        f"encode: {t_enc:.2f}s  count={count} profile={profile} caps={caps}",
        file=sys.stderr,
    )

    t0 = time.time()
    ops, starts, bbuf, ins, Lrr = eng.enc_fill(
        part, caps.R, caps.C, caps.L, NI, B=caps.B
    )
    t_fill = time.time() - t0
    nbytes = sum(a.nbytes for a in (ops, starts, bbuf, ins, Lrr))
    print(f"enc_fill: {t_fill:.2f}s  upload bytes={nbytes/1e6:.1f} MB",
          file=sys.stderr)

    def timed(label, fn, reps=2):
        fn()  # warm/compile
        t = time.time()
        for _ in range(reps):
            r = fn()
        dt = (time.time() - t) / reps
        print(f"{label}: {dt*1000:.0f} ms", file=sys.stderr)
        return r, dt

    # upload
    def up():
        arrs = tuple(
            jax.device_put(a) for a in (ops, starts, bbuf, ins, Lrr)
        )
        jax.block_until_ready(arrs)
        np.asarray(arrs[4])  # force a real sync with the device
        return arrs

    (d_ops, d_starts, d_bb, d_ins, d_Lr), t_up = timed("upload", up)

    # build (sync via flags fetch — forces the whole build)
    def bld():
        b = device_build(d_ops, d_starts, d_bb, d_ins, d_Lr, caps)
        np.asarray(b["flags"])
        return b

    build, t_build = timed("device_build", bld)

    def dp():
        s = dp_scores(
            build["win"], build["exit_cnt"], build["cov"],
            build["unsup"], build["long_u"], build["long_w"],
            build["long_esc"],
        )
        np.asarray(s[:, 0])
        return s

    scores, t_dp = timed("dp_scores", dp)

    P = min(caps.V, 2 * caps.L + 64)

    def emit_fn():
        e = devemit.backtrack_emit(build, scores, jnp.int32(7), P)
        np.asarray(e["path_len"])
        return e

    emit, t_emit = timed("backtrack_emit", emit_fn)

    def fetch():
        return {k: np.asarray(v) for k, v in emit.items()}

    _, t_fetch = timed("fetch", fetch)

    tot = t_up + t_build + t_dp + t_emit + t_fetch
    bases = caps.B * length
    print(
        f"TOTAL device path: {tot:.2f}s/batch of {caps.B} "
        f"(~{bases/tot:,.0f} b/s excluding host encode)",
        file=sys.stderr,
    )
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
