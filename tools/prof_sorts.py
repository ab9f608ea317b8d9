"""Microbenchmark: lax.sort patterns used by devbuild vs sort-free MXU
formulations (ops/mxu.py), at the shapes the bench workload actually
compiles (B=128, R*C ~ 41k, N=R*CH ~ 4k, NF ~ 49k, V ~ 4.6k).

    python tools/prof_sorts.py

Prints ms/iter for each candidate; exactness is asserted in-run against
the sort-based answers.
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import jax
import jax.numpy as jnp
import numpy as np

from pbdagcon_tpu.ops import mxu

B = 128


def bench(name, fn, *args, reps=20):
    f = jax.jit(fn)
    r = f(*args)
    jax.block_until_ready(r)
    t0 = time.time()
    for _ in range(reps):
        r = f(*args)
    jax.block_until_ready(r)
    dt = (time.time() - t0) / reps * 1000
    print(f"{name:48s} {dt:8.2f} ms", flush=True)
    return r


def main():
    print(f"platform={jax.devices()[0].platform}")
    rng = np.random.default_rng(0)

    # ---- histogram family: N=40960 values over D=1026 ----------------
    N, D = 40960, 1026
    vals = jnp.asarray(rng.integers(0, D, (B, N)), dtype=jnp.int32)
    valid = jnp.asarray(rng.random((B, N)) < 0.9)

    def h_sort(v, m):
        sv = jnp.sort(jnp.where(m, v.astype(jnp.int16), jnp.int16(D + 1)),
                      axis=-1)
        q = jnp.broadcast_to(jnp.arange(D, dtype=jnp.int16), (B, D))
        qq = jnp.concatenate([q, q + 1], axis=-1)
        fn = jax.vmap(lambda r, x: jnp.searchsorted(r, x, method="sort"))
        both = fn(sv, qq)
        return (both[:, D:] - both[:, :D]).astype(jnp.int32)

    def h_mxu(v, m):
        return mxu.mxu_hist(v, m, D)

    def h_sumeq(v, m):
        vm = jnp.where(m, v, -1)
        return jnp.sum(
            vm[:, :, None] == jnp.arange(D, dtype=jnp.int32)[None, None, :],
            axis=1, dtype=jnp.int32,
        )

    def h_scat(v, m):
        out = jnp.zeros((B, D), jnp.int32)
        return out.at[
            jnp.arange(B, dtype=jnp.int32)[:, None],
            jnp.where(m, v, 0),
        ].add(jnp.where(m, 1, 0))

    a = bench("hist[41k,D=1026] sort+ss (current)", h_sort, vals, valid)
    b = bench("hist[41k,D=1026] MXU one-hot", h_mxu, vals, valid)
    c = bench("hist[41k,D=1026] fused compare-reduce", h_sumeq, vals, valid)
    d = bench("hist[41k,D=1026] scatter-add", h_scat, vals, valid)
    assert (np.asarray(a) == np.asarray(b)).all(), "MXU hist mismatch"
    assert (np.asarray(a) == np.asarray(c)).all()
    assert (np.asarray(a) == np.asarray(d)).all()

    # ---- histogram: absorption class-hist shape N=4096, D=8208 -------
    N2, D2 = 4096, 8208
    v2 = jnp.asarray(rng.integers(0, D2, (B, N2)), dtype=jnp.int32)
    m2 = jnp.asarray(rng.random((B, N2)) < 0.5)

    def h2_sort(v, m):
        sv = jnp.sort(jnp.where(m, v.astype(jnp.uint16), jnp.uint16(D2 + 1)),
                      axis=-1)
        q = jnp.broadcast_to(jnp.arange(D2 + 1, dtype=jnp.uint16),
                             (B, D2 + 1))
        fn = jax.vmap(lambda r, x: jnp.searchsorted(r, x, method="sort"))
        bd = fn(sv, q)
        return (bd[:, 1:] - bd[:, :-1]).astype(jnp.int32)

    def h2_mxu(v, m):
        return mxu.mxu_hist(v, m, D2)

    a2 = bench("hist[4k,D=8208] sort+ss (current)", h2_sort, v2, m2)
    b2 = bench("hist[4k,D=8208] MXU one-hot", h2_mxu, v2, m2)
    assert (np.asarray(a2) == np.asarray(b2)).all(), 'h2 mismatch'

    # ---- transport sorts (cost anchors) ------------------------------
    k16 = jnp.asarray(rng.integers(0, 1 << 16, (B, N)), dtype=jnp.uint16)
    p16 = jnp.asarray(rng.integers(0, 1 << 16, (B, N)), dtype=jnp.uint16)
    p16b = jnp.asarray(rng.integers(0, 1 << 16, (B, N)), dtype=jnp.uint16)
    p16c = jnp.asarray(rng.integers(0, 1 << 16, (B, N)), dtype=jnp.uint16)
    bench("sort[41k] u16 2-op", lambda a_, b_: jax.lax.sort(
        (a_, b_), dimension=-1, num_keys=1), k16, p16)
    bench("sort[41k] u16 4-op", lambda a_, b_, c_, d_: jax.lax.sort(
        (a_, b_, c_, d_), dimension=-1, num_keys=1), k16, p16, p16b, p16c)
    k32 = k16.astype(jnp.int32)
    bench("sort[41k] i32 2-op", lambda a_, b_: jax.lax.sort(
        (a_, b_), dimension=-1, num_keys=1), k32, p16.astype(jnp.int32))
    kn = jnp.asarray(rng.integers(0, 1 << 16, (B, N2)), dtype=jnp.uint16)
    pn = jnp.asarray(rng.integers(0, 1 << 16, (B, N2)), dtype=jnp.uint16)
    bench("sort[4k] u16 2-op", lambda a_, b_: jax.lax.sort(
        (a_, b_), dimension=-1, num_keys=1), kn, pn)
    NF = 49152
    kf = jnp.asarray(rng.integers(0, 2, (B, NF)), dtype=jnp.uint16)
    pf = jnp.asarray(rng.integers(0, NF, (B, NF)), dtype=jnp.uint16)
    bench("sort[49k] u16 2-op (compact-flag)", lambda a_, b_: jax.lax.sort(
        (a_, b_), dimension=-1, num_keys=2), kf, pf)

    # ---- scatter with known ranks: compaction NF=49k -> ND=3072 ------
    ND = 3072
    flags = jnp.asarray(rng.random((B, NF)) < ND / NF * 0.8)

    def compact_sort(fl):
        ck = jnp.where(fl, jnp.uint16(0), jnp.uint16(1))
        cpos = jnp.broadcast_to(jnp.arange(NF, dtype=jnp.uint16), (B, NF))
        _s, cp = jax.lax.sort((ck, cpos), dimension=-1, num_keys=2)
        return cp[:, :ND].astype(jnp.int32)

    def compact_mxu(fl):
        rank = jnp.cumsum(fl, axis=-1, dtype=jnp.int32) - 1
        pos = jnp.broadcast_to(jnp.arange(NF, dtype=jnp.int32), (B, NF))
        (out,) = mxu.mxu_scatter(rank, fl, (pos,), ND)
        return out

    a3 = bench("compact[49k->3072] sort (current)", compact_sort, flags)
    b3 = bench("compact[49k->3072] MXU scatter", compact_mxu, flags)
    na, nb = np.asarray(a3), np.asarray(b3)
    nv = np.asarray(jnp.sum(flags, axis=-1))
    for i in range(B):
        k = min(nv[i], ND)
        assert (na[i, :k] == nb[i, :k]).all(), f"compact mismatch row {i}"

    # ---- scatter: permutation transport N=41k -> D=41k ---------------
    perm = np.stack([rng.permutation(N) for _ in range(B)])
    ranks = jnp.asarray(perm, dtype=jnp.int32)
    pay = jnp.asarray(rng.integers(0, 1 << 16, (B, N)), dtype=jnp.int32)

    def perm_sort(r, p):
        _s, sp = jax.lax.sort(
            (r.astype(jnp.uint16) if N < (1 << 16) else r,
             p.astype(jnp.uint16)),
            dimension=-1, num_keys=1)
        return sp.astype(jnp.int32)

    def perm_mxu(r, p):
        (out,) = mxu.mxu_scatter(r, jnp.ones_like(r, bool), (p,), N)
        return out

    a4 = bench("perm[41k->41k] sort u16 (current)", perm_sort, ranks, pay)
    b4 = bench("perm[41k->41k] MXU scatter", perm_mxu, ranks, pay)
    assert (np.asarray(a4) == np.asarray(b4)).all()

    # ---- interleave transport (assemble classify): D=V=4608 ----------
    V = 4608
    NDv, Lv = 3072, 1026
    lin_t = np.sort(
        np.stack([rng.choice(V, NDv, replace=False) for _ in range(B)]),
        axis=-1)
    pay_t = rng.integers(0, 1 << 16, (B, NDv))
    rt = jnp.asarray(lin_t, jnp.int32)
    pt = jnp.asarray(pay_t, jnp.int32)

    def inter_mxu(r, p):
        (out,) = mxu.mxu_scatter(r, jnp.ones_like(r, bool), (p,), V)
        return out

    def inter_sort(r, p):
        key = jnp.concatenate(
            [r, jnp.full((B, V - NDv), 1 << 28, jnp.int32)], axis=-1)
        pv = jnp.concatenate(
            [p, jnp.zeros((B, V - NDv), jnp.int32)], axis=-1)
        _s, sp = jax.lax.sort((key, pv), dimension=-1, num_keys=1)
        return sp

    a5 = bench("classify[3k+1k->V] sort i32 (current)", inter_sort, rt, pt)
    b5 = bench("classify[3k+1k->V] MXU scatter", inter_mxu, rt, pt)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
