"""Micro-benchmarks for layout-sensitive ops on the real chip.

    python tools/microbench_layout.py
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import jax
import jax.numpy as jnp
import numpy as np


def timeit(name, fn, *args, reps=5):
    # reduce to a scalar on device: fetching full outputs would time
    # the device-to-host copy, not the op.
    f = jax.jit(
        lambda *a: sum(
            jnp.sum(x.astype(jnp.float32))
            for x in jax.tree_util.tree_leaves(
                jax.lax.optimization_barrier(fn(*a))
            )
        )
    )
    np.asarray(f(*args))
    t0 = time.time()
    for _ in range(reps):
        np.asarray(f(*args))
    dt = (time.time() - t0) / reps
    print(f"{name:55s} {dt*1000:8.1f} ms", file=sys.stderr, flush=True)
    return dt


def main():
    B, SM, N = 128, 8, 12288
    rng = np.random.default_rng(0)
    ba = jnp.asarray(rng.integers(0, 1 << 20, (B, SM, N), dtype=np.int32))
    ba_nm = jnp.asarray(
        rng.integers(0, 1 << 20, (B, N, SM), dtype=np.int32)
    )
    sidx = jnp.asarray(
        np.argsort(rng.random((B, N)), axis=-1).astype(np.int32)
    )
    print(f"platform={jax.devices()[0].platform}", file=sys.stderr)

    timeit("null (dispatch floor)", lambda a: a[:, 0, 0], ba)
    timeit("g2 gather axis2 [B,SM,N] out 12.6M",
           lambda a, i: jnp.take_along_axis(a, i[:, None, :], axis=2),
           ba, sidx)
    timeit("g2 gather axis1 [B,N,SM] out 12.6M (old layout)",
           lambda a, i: jnp.take_along_axis(a, i[:, :, None], axis=1),
           ba_nm, sidx)
    timeit("g2 gather flat [B, SM*N] via d*N+idx",
           lambda a, i: jnp.take_along_axis(
               a.reshape(B, SM * N),
               (jnp.arange(SM, dtype=jnp.int32)[None, :, None] * N
                + i[:, None, :]).reshape(B, SM * N),
               axis=-1,
           ),
           ba, sidx)
    timeit("transpose+reshape [B,SM,N]->[B,N*SM]",
           lambda a: a.transpose(0, 2, 1).reshape(B, N * SM) + 1, ba)
    timeit("reshape only [B,SM,N]->[B,SM*N]",
           lambda a: a.reshape(B, SM * N) + 1, ba)
    timeit("8x dense slice-select [B,SM,N]",
           lambda a: sum(a[:, d, :] for d in range(SM)), ba)
    # the old-layout fl() pattern: padded [B,N,SM] -> flat dense
    timeit("reshape [B,N,SM]->[B,N*SM] (padded src)",
           lambda a: a.reshape(B, N * SM) + 1, ba_nm)
    # sorts for scale
    timeit("lax.sort 1-op [B, 73728]",
           lambda a: jax.lax.sort(a.reshape(B, -1), dimension=-1),
           jnp.asarray(
               rng.integers(0, 1 << 20, (B, 73728), dtype=np.int32)
           ))
    timeit("lax.sort 2-op [B, 12288]",
           lambda a, v: jax.lax.sort((a, v), dimension=-1, num_keys=1),
           jnp.asarray(
               rng.integers(0, 1 << 20, (B, N), dtype=np.int32)
           ),
           jnp.asarray(
               rng.integers(0, 1 << 20, (B, N), dtype=np.int32)
           ))
    timeit("row gather [B,N] out (idx random)",
           lambda a, i: jnp.take_along_axis(a[:, 0, :], i, axis=-1),
           ba, sidx)
    timeit("row gather [B, 8N] out (idx random, one flat)",
           lambda a, i: jnp.take_along_axis(
               a.reshape(B, SM * N),
               jnp.concatenate([i] * SM, axis=-1), axis=-1),
           ba, sidx)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
