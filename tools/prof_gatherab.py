"""A/B: time device_build with all take_along_axis calls replaced by a
shape-identical non-gather stub (results are WRONG — timing only).

    python tools/prof_gatherab.py
"""
import functools
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main() -> int:
    n_targets, cov, length = 128, 30, 1000

    import jax
    import jax.numpy as jnp

    # Patch BEFORE importing devbuild_jax so its module body (if any)
    # and all call sites resolve the stub.
    orig = jnp.take_along_axis

    def fake(arr, idx, axis=-1, **kw):
        # same output shape/dtype, no data-dependent addressing
        ax = axis % arr.ndim
        sl = [slice(None)] * arr.ndim
        sl[ax] = slice(0, 1)
        base = arr[tuple(sl)]
        shape = list(arr.shape)
        shape[ax] = idx.shape[ax]
        out_shape = jnp.broadcast_shapes(tuple(shape), idx.shape)
        return jnp.broadcast_to(base, out_shape).astype(arr.dtype) + (
            jnp.zeros(out_shape, arr.dtype)
        )

    mode = sys.argv[1] if len(sys.argv) > 1 else "fake"
    if mode == "fake":
        jnp.take_along_axis = fake
    elif mode == "barrier":
        def barriered(arr, idx, axis=-1, **kw):
            arr = jax.lax.optimization_barrier(arr)
            idx = jax.lax.optimization_barrier(idx)
            return jax.lax.optimization_barrier(
                orig(arr, idx, axis=axis, **kw)
            )
        jnp.take_along_axis = barriered
    elif mode == "barrier_out":
        def barriered_o(arr, idx, axis=-1, **kw):
            return jax.lax.optimization_barrier(
                orig(arr, idx, axis=axis, **kw)
            )
        jnp.take_along_axis = barriered_o

    from pbdagcon_tpu import native
    from pbdagcon_tpu.devpipe import (
        DevCapsConfig, _B_LADDER, _C_LADDER, _L_LADDER, _R_LADDER,
        _ladder, caps_for, ins_cap,
    )
    from pbdagcon_tpu.ops import devbuild_jax as dj
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

    print(f"platform={jax.devices()[0].platform} mode={mode}",
          file=sys.stderr)
    assert native.ensure_built()
    lines = []
    for _tid, _bb, alns in simulate_targets(
        1234, n_targets, length, cov, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    eng = native.NativeEngine(
        min_weight=max(2, cov // 4), min_length=100, threads=4, align=True
    )
    count = eng.encode_text(("\n".join(lines) + "\n").encode(),
                            fmt="pre", flush=True)
    metas = eng.enc_metas(count)
    dcfg = (
        DevCapsConfig.compact()
        if int(metas[:, 3].sum()) <= 0.11 * max(1, int(metas[:, 4].sum()))
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
    NI = ins_cap(caps)
    part = [i for i in range(count) if int(metas[i, 3]) <= NI][: caps.B]
    arrs = eng.enc_fill(part, caps.R, caps.C, caps.L, NI, B=caps.B)
    d = tuple(jax.device_put(np.asarray(a)) for a in arrs)

    def chks(tree):
        leaves = jax.tree_util.tree_leaves(tree)
        return sum(
            jnp.sum(l.astype(jnp.int32) if l.dtype == bool else l)
            .astype(jnp.float32)
            for l in leaves
            if jnp.issubdtype(l.dtype, jnp.number) or l.dtype == bool
        )

    f = jax.jit(lambda *a: chks(dj.device_build(*a, caps)))
    t0 = time.time()
    np.asarray(f(*d))
    print(f"compile {time.time()-t0:.0f}s", file=sys.stderr)
    t0 = time.time()
    for _ in range(5):
        np.asarray(f(*d))
    print(f"mode={mode}: {(time.time()-t0)/5*1000:.0f} ms/batch",
          file=sys.stderr)
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
