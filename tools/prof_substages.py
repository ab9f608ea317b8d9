"""Sub-stage attribution INSIDE apply_absorption / linearize_and_band /
assemble_band via their _upto hooks, on the real chip.

    python tools/prof_substages.py [stage]   # stage in {absorb, linz, asm}
"""
import functools
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    n_targets, cov, length = 128, 30, 1000

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
    caps = caps_for(
        _ladder(count, _B_LADDER) or _B_LADDER[-1],
        _ladder(int(metas[:, 0].max()), _R_LADDER),
        _ladder(int(metas[:, 1].max()), _C_LADDER),
        _ladder(int(metas[:, 2].max()), _L_LADDER),
        dcfg,
        ch_need=int(metas[:, 5].max()), sm_need=int(metas[:, 6].max()),
        nd_need=int(metas[:, 3].max()), dq_need=int(metas[:, 7].max()),
        se_need=int(metas[:, 8].max()), w_need=64,
    )
    print(f"caps: {caps}", file=sys.stderr)
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

    def prefix(stage, upto, ops, starts, bb, ins_base, Lr):
        dec = dj.decode_columns(ops, starts, caps)
        cov_, matches = dj.coverage_and_matches(ops, starts, dec, caps)
        mtab = dj.matched_positions(ops, dec, starts, Lr, caps)
        chains = dj.extract_chains(ops, starts, ins_base, dec, mtab[0], Lr, caps)
        trans = dj.transitions_table(dec, mtab, chains, starts, Lr, caps)
        if stage == "absorb":
            return chks(dj.apply_absorption(chains, trans, bb, Lr, caps,
                                            _upto=upto))
        absb = dj.apply_absorption(chains, trans, bb, Lr, caps)
        fc = {
            "valid": absb["valid"].reshape(caps.B, -1),
            "p": absb["p"], "t": absb["t"], "len": absb["len"],
            "rev_ba": absb["rev_ba"],
            "read": absb["read"], "phase": absb["phase"], "seq": absb["seq"],
        }
        tri = dj.build_tries(fc, Lr, caps)
        if stage == "linz":
            return chks(dj.linearize_and_band(
                tri, fc, absb, trans, cov_, matches, bb, Lr, caps,
                _upto=upto))
        linz = dj.linearize_and_band(
            tri, fc, absb, trans, cov_, matches, bb, Lr, caps
        )
        return chks(dj.assemble_band(
            linz, absb, trans, cov_, matches, bb, Lr, caps, _upto=upto))

    stages = {
        "absorb": range(1, 8), "linz": range(1, 7), "asm": range(1, 8),
    }
    for stage, rng_ in stages.items():
        if which not in ("all", stage):
            continue
        prev = 0.0
        for k in list(rng_):
            upto = 0 if k == max(rng_) else k
            if upto == 0 and k != max(rng_):
                continue
            f = jax.jit(functools.partial(prefix, stage, upto))
            t0 = time.time()
            np.asarray(f(*d))
            tc = time.time() - t0
            t0 = time.time()
            for _ in range(3):
                np.asarray(f(*d))
            dt = (time.time() - t0) / 3
            print(
                f"{stage} upto={upto}: {dt*1000:7.0f} ms "
                f"(+{(dt-prev)*1000:6.0f})  [compile {tc:.0f}s]",
                file=sys.stderr, flush=True,
            )
            prev = dt
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
