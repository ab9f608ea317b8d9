"""Ablation profiler for device_build: replace one suspect op with a
shape-identical stand-in (devbuild_jax._ABLATE) and measure the FULL
build's delta — fusion stays intact, so the delta is the op's true
in-context cost. Prefix-difference profiling (prof_devbuild_stages /
prof_substages) mis-attributes tens of ms to materialization at stage
boundaries; this is the honest per-op instrument.

    python tools/ablate_devbuild.py [names...]
"""
import functools
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

NAMES = [
    "baseline",
    "extract_ba",
    "tries_g2",
    "linz_planes",
    "linz_ra",
    "asm_base_gb",
    "asm_sort",
    "asm_se_scatter",
    "asm_dq_gather",
    "asm_band",
    "mpos_sort",
    "extract_sort",
    "chain_ss",
    "cov_hist",
    "match_hist",
    "trans_hist",
    "absorb_hists",
    "absorb_dl_sort",
    "absorb_died_sort",
    "tries_sort",
    "linz_postorder",
    "linz_preorder",
    "linz_se_sort",
    "linz_hist",
    "asm_hse",
    "asm_su_sort",
]


def main() -> int:
    which = sys.argv[1:] or NAMES
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
        1234, 128, 1000, 30, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()
    eng = native.NativeEngine(
        min_weight=7, min_length=100, threads=4, align=True
    )
    count = eng.encode_text(text, fmt="pre", flush=True)
    metas = eng.enc_metas(count)
    caps = caps_for(
        _ladder(count, _B_LADDER) or _B_LADDER[-1],
        _ladder(int(metas[:, 0].max()), _R_LADDER),
        _ladder(int(metas[:, 1].max()), _C_LADDER),
        _ladder(int(metas[:, 2].max()), _L_LADDER),
        DevCapsConfig.compact(),
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

    build = dj.device_build.__wrapped__
    base = None
    for name in which:
        dj._ABLATE = (
            frozenset() if name == "baseline" else frozenset({name})
        )
        f = jax.jit(
            lambda o, s, b, i, L: chks(build(o, s, b, i, L, caps))
        )
        t0 = time.time()
        np.asarray(f(*d))
        tc = time.time() - t0
        ts = []
        for _ in range(3):
            t0 = time.time()
            np.asarray(f(*d))
            ts.append(time.time() - t0)
        dt = min(ts)
        if name == "baseline":
            base = dt
            print(f"{name:16s} {dt*1000:7.0f} ms   [compile {tc:.0f}s]",
                  flush=True)
        else:
            dl = (base - dt) * 1000 if base else float("nan")
            print(
                f"{name:16s} {dt*1000:7.0f} ms  (op cost ~{dl:5.0f} ms)"
                f"  [compile {tc:.0f}s]",
                flush=True,
            )
    dj._ABLATE = frozenset()
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
