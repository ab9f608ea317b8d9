"""Sub-stage attribution for device_build on the real chip: time jitted
prefixes of the stage chain; differences give per-stage cost (fusion
across stage boundaries shifts a little work between neighbours, but the
big numbers are unambiguous).

    python tools/prof_devbuild_stages.py [n_targets] [cov]
"""
import functools
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
        DevCapsConfig, _B_LADDER, _C_LADDER, _L_LADDER, _R_LADDER,
        _ladder, caps_for, ins_cap,
    )
    from pbdagcon_tpu.ops import devbuild_jax as dj
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
    count = eng.encode_text(text, fmt="pre", flush=True)
    metas = eng.enc_metas(count)
    tot_ins = int(metas[:, 3].sum())
    tot_cols = int(metas[:, 4].sum())
    dcfg = (
        DevCapsConfig.compact()
        if tot_ins <= 0.11 * max(1, tot_cols)
        else DevCapsConfig.heavy()
    )
    Rb = _ladder(int(metas[:, 0].max()), _R_LADDER)
    Cb = _ladder(int(metas[:, 1].max()), _C_LADDER)
    Lb = _ladder(int(metas[:, 2].max()), _L_LADDER)
    caps = caps_for(
        _ladder(count, _B_LADDER) or _B_LADDER[-1], Rb, Cb, Lb, dcfg,
        ch_need=int(metas[:, 5].max()),
        sm_need=int(metas[:, 6].max()),
        nd_need=int(metas[:, 3].max()),
        dq_need=int(metas[:, 7].max()),
        se_need=int(metas[:, 8].max()),
        w_need=int(sys.argv[3]) if len(sys.argv) > 3 else 64,
    )
    NI = ins_cap(caps)
    part = [i for i in range(count) if int(metas[i, 3]) <= NI][: caps.B]
    ops, starts, bbuf, ins, Lrr = eng.enc_fill(
        part, caps.R, caps.C, caps.L, NI, B=caps.B
    )
    d = tuple(jax.device_put(np.asarray(a)) for a in
              (ops, starts, bbuf, ins, Lrr))
    np.asarray(d[4])

    def chks(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        return sum(
            jnp.sum(l.astype(jnp.int32) if l.dtype == bool else l)
            .astype(jnp.float32)
            for l in leaves
            if jnp.issubdtype(l.dtype, jnp.number) or l.dtype == bool
        )

    def upto(k, ops, starts, bb, ins_base, Lr):
        dec = dj.decode_columns(ops, starts, caps)
        if k == 0:
            return chks(dec)
        cov_, matches = dj.coverage_and_matches(ops, starts, dec, caps)
        if k == 1:
            return chks((cov_, matches))
        mtab = dj.matched_positions(ops, dec, starts, Lr, caps)
        if k == 2:
            return chks(mtab)
        chains = dj.extract_chains(ops, starts, ins_base, dec, mtab[0], Lr, caps)
        if k == 3:
            return chks(chains)
        trans = dj.transitions_table(dec, mtab, chains, starts, Lr, caps)
        if k == 4:
            return chks(trans)
        absb = dj.apply_absorption(chains, trans, bb, Lr, caps)
        if k == 5:
            return chks(absb)
        fc = {
            "valid": absb["valid"].reshape(caps.B, -1),
            "p": absb["p"], "t": absb["t"], "len": absb["len"],
            "rev_ba": absb["rev_ba"],
            "read": absb["read"], "phase": absb["phase"], "seq": absb["seq"],
        }
        tri = dj.build_tries(fc, Lr, caps)
        if k == 6:
            return chks(tri)
        linz = dj.linearize_and_band(
            tri, fc, absb, trans, cov_, matches, bb, Lr, caps
        )
        if k == 7:
            return chks(linz)
        out = dj.assemble_band(linz, absb, trans, cov_, matches, bb, Lr, caps)
        return chks(out)

    names = [
        "decode_columns", "coverage_and_matches", "matched_positions",
        "extract_chains", "transitions_table", "apply_absorption",
        "build_tries", "linearize_and_band", "assemble_band",
    ]
    prev = 0.0
    for k in range(9):
        f = jax.jit(functools.partial(upto, k))
        t0 = time.time()
        np.asarray(f(*d))
        t_compile = time.time() - t0
        t0 = time.time()
        reps = 2
        for _ in range(reps):
            np.asarray(f(*d))
        dt = (time.time() - t0) / reps
        print(
            f"prefix {k} ({names[k]}): {dt*1000:7.0f} ms "
            f"(+{(dt-prev)*1000:6.0f} ms)  [compile {t_compile:.0f}s]",
            file=sys.stderr, flush=True,
        )
        prev = dt
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
