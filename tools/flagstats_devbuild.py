"""Tally devbuild fallback-flag classes on a bench-like workload (CPU).

Usage: python tools/flagstats_devbuild.py [n_targets] [length] [cov]
Prints per-class counts so fallback-reduction work targets the real
offender, not a guess.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp

from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.devpipe import (
    DevCapsConfig, _B_LADDER, _C_LADDER, _L_LADDER, _R_LADDER,
    _ladder, _pack_batch, caps_for, chain_stats, encode_groups, ins_cap,
)
from pbdagcon_tpu.io import TargetGroup
from pbdagcon_tpu.ops import devemit
from pbdagcon_tpu.ops.devbuild_jax import device_build
from pbdagcon_tpu.ops.dp import dp_scores
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets


def main() -> None:
    n_targets = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    length = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    cov = int(sys.argv[3]) if len(sys.argv) > 3 else 30

    cfg = DagconConfig(
        min_weight=max(2, cov // 4), min_length=100, align=True,
        batch_targets=128,
    )
    groups = [
        TargetGroup(sid=t, backbone=bb, alns=alns)
        for t, bb, alns in simulate_targets(
            1234, n_targets, length, cov, NoiseProfile()
        )
    ]

    tallies: dict[str, int] = {}
    total = 0
    encs = [e for _g, e in encode_groups(groups, cfg) if e is not None]
    Rb = _ladder(max(e.ops.shape[0] for e in encs), _R_LADDER)
    Cb = _ladder(max(e.ops.shape[1] for e in encs), _C_LADDER)
    Lb = _ladder(max(len(e.backbone) for e in encs), _L_LADDER)
    tot_ins = sum(len(e.ins_base) for e in encs)
    tot_cols = sum(int(e.ncols.sum()) for e in encs)
    prof = (
        DevCapsConfig.compact()
        if tot_ins <= 0.11 * max(1, tot_cols)
        else DevCapsConfig.heavy()
    )
    stats_all = [chain_stats(e.ops, e.starts) for e in encs]
    nd_n = max(len(e.ins_base) for e in encs)
    caps = caps_for(
        _ladder(len(encs), _B_LADDER) or _B_LADDER[-1], Rb, Cb, Lb, prof,
        ch_need=max(s[0] for s in stats_all),
        sm_need=max(s[1] for s in stats_all),
        nd_need=nd_n,
        dq_need=max(s[2] for s in stats_all),
        se_need=max(s[3] for s in stats_all),
    )
    print(f"caps: {caps}  profile={'compact' if prof.W == 64 else 'heavy'}")
    for lo in range(0, len(encs), caps.B):
        part = encs[lo : lo + caps.B]
        n_real = len(part)
        while len(part) < caps.B:
            part = part + [part[0]]
        ops, starts, bbuf, ins, Lrr = _pack_batch(part, caps)
        build = device_build(
            jnp.asarray(ops), jnp.asarray(starts), jnp.asarray(bbuf),
            jnp.asarray(ins), jnp.asarray(Lrr), caps,
        )
        scores = dp_scores(
            build["win"], build["exit_cnt"], build["cov"],
            build["unsup"], build["long_u"], build["long_w"],
            build["long_esc"],
        )
        P = min(caps.V, 2 * caps.L + 64)
        emit = devemit.backtrack_emit(
            build, scores, jnp.int32(cfg.min_weight), P
        )
        detail = {k: np.asarray(v) for k, v in build["flag_detail"].items()}
        detail["ambiguous"] = np.asarray(emit["ambiguous"])
        detail["emit_overflow"] = np.asarray(emit["overflow"])
        total += n_real
        for k, v in detail.items():
            tallies[k] = tallies.get(k, 0) + int(v[:n_real].sum())
        any_flag = np.asarray(build["flags"])[:n_real] | detail[
            "ambiguous"
        ][:n_real] | detail["emit_overflow"][:n_real]
        tallies["TOTAL_FALLBACK"] = tallies.get(
            "TOTAL_FALLBACK", 0
        ) + int(any_flag.sum())

    print(f"targets={total}")
    for k in sorted(tallies, key=lambda k: -tallies[k]):
        print(f"  {k:16s} {tallies[k]:5d}  ({100*tallies[k]/total:.1f}%)")


if __name__ == "__main__":
    main()
