"""One-hot matmul histograms, grid searchsorted, and unique-rank scatters.

(The `mxu_` prefix names the matrix-unit formulation; on the GPU these
are bf16 matmuls with f32 accumulation on the tensor cores.)

The devbuild program's `lax.sort` calls fall into three families, two of
which do not actually need a comparison sort:

  1. **Histograms** — sort the values, then `searchsorted` a full
     integer grid to read off run lengths. The counts per key over a
     known domain D are a *counting* problem, not a sorting problem.
  2. **Searchsorted on a full grid** — `lo[d] = #{v < d}`,
     `hi[d] = #{v <= d}` for every d in 0..D-1. These are exclusive /
     inclusive prefix sums of the same histogram.
  3. **Scatters with known ranks** — "sort by key" where the key *is* a
     precomputed destination rank (stable compaction by a flag, a
     computed permutation, interleaving two ascending sequences). The
     sort is only transport; the destination of every element is
     already known.

All three have an exact, sort-free matmul formulation via factorized
one-hot matmuls. Write the destination d = dh*128 + dl; then

    hist[dh, dl]  = sum_n A[n, dh] * B[n, dl]          =  A^T @ B
    out[dh, dl]   = sum_n A[n, dh] * (B[n, dl] * p_n)  =  A^T @ (B*p)

where A[n, dh] = 1[v_n div 128 == dh] (AND validity) and
B[n, dl] = 1[v_n mod 128 == dl]. The cross terms vanish because the
product A[n,dh]*B[n,dl] is 1 iff v_n == dh*128+dl exactly. One-hot
entries are exactly 0.0/1.0 in bf16; with float32 accumulation
(`preferred_element_type`) histogram counts are exact up to 2^24 and
scatter payloads are exact when byte-split (each byte <= 255 is exact
in bf16, and unique ranks mean each output cell receives exactly one
nonzero term). This moves the work onto the matrix unit — which is
otherwise idle during the graph build — instead of a comparison sort.
Each form materializes its one-hot operands in device memory; whether
the plain gather / scatter-add / segment-sum beats it on a given
device is measured, not assumed (PERF.md).

Used by `ops/devbuild_jax.py` (reference: the `AlnGraphBoost`
`addAln`/`mergeNodes` pipeline, src/cpp/AlnGraphBoost.cpp ~180-380,
SURVEY.md §3.3 — reconstructed; mount empty). Bit-exactness is pinned
by `tests/test_mxu.py` against NumPy and by the existing devbuild
differential suite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32
BF16 = jnp.bfloat16
_LANES = 128


def _pad_chunks(x, chunk, fill):
    """[B, N] -> [B, nc, chunk] padded with `fill`."""
    B, N = x.shape
    nc = -(-N // chunk)
    pad = nc * chunk - N
    if pad:
        x = jnp.concatenate(
            [x, jnp.full((B, pad), fill, dtype=x.dtype)], axis=-1
        )
    return x.reshape(B, nc, chunk)


def _factor_onehots(vals, dh_count):
    """vals [B, Nc] i32 (invalid rows must hold -1) ->
    A [B, Nc, dh_count] bf16, Bm [B, Nc, LANES] bf16."""
    vh = vals // _LANES
    vl = vals % _LANES  # -1 -> (-1, 127) in python semantics; vh=-1 kills it
    a = (
        vh[..., None] == jnp.arange(dh_count, dtype=I32)
    ).astype(BF16)
    bm = (
        vl[..., None] == jnp.arange(_LANES, dtype=I32)
    ).astype(BF16)
    return a, bm


def _matmul_acc(a, bm):
    """Batched A^T @ B with f32 accumulation: [B, Nc, H] x [B, Nc, M]
    -> [B, H, M]."""
    return jax.lax.dot_general(
        a, bm,
        dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )


def mxu_hist(values, valid, D, *, chunk: int = 4096):
    """Counts per value over domain [0, D): [B, N] -> [B, D] i32.

    Small domains (D <= 2048) take a fused compare-and-reduce, large
    ones the factorized one-hot matmul. Both are exact: integer sums
    below 2^24."""
    B, N = values.shape
    v = jnp.where(valid, values.astype(I32), jnp.int32(-1))
    if D <= 2048:
        return jnp.sum(
            v[:, :, None] == jnp.arange(D, dtype=I32)[None, None, :],
            axis=1, dtype=I32,
        )
    dh = -(-D // _LANES)
    vc = _pad_chunks(v, chunk, -1)
    nc = vc.shape[1]

    def body(acc, vals):
        a, bm = _factor_onehots(vals, dh)
        return acc + _matmul_acc(a, bm), None

    if nc == 1:
        a, bm = _factor_onehots(vc[:, 0], dh)
        acc = _matmul_acc(a, bm)
    else:
        acc, _ = jax.lax.scan(
            body,
            jnp.zeros((B, dh, _LANES), jnp.float32),
            jnp.moveaxis(vc, 1, 0),
        )
    return acc.reshape(B, dh * _LANES)[:, :D].astype(I32)


def mxu_gather(tbl, idx, *, max_val: int, valid=None):
    """Sort-free, loop-free gather out[b, n] = tbl[b, idx[b, n]] as a
    factorized one-hot matmul.

    out = sum_h 1[idx div 128 == h] * (B2 @ plane_h^T) with
    B2[n, l] = 1[idx mod 128 == l] and the table byte-split so every
    bf16 factor is an exact small integer; each output cell receives
    exactly one nonzero term, so the f32 result is exact.

    tbl: [B, T] integer in [0, max_val); idx: [B, N]. Out-of-range
    indices are CLAMPED to the padded table bounds (they read a real
    boundary element, or 0 in the zero-padded tail T..dh*128); indices
    masked off via `valid` genuinely read 0. Callers that need
    out-of-range reads to be 0 must pre-clip or pass `valid`. Use only
    for T <= ~16k (cost scales with T); wider tables should keep the
    elementwise gather."""
    B, T = tbl.shape
    dh = -(-T // _LANES)
    pad = dh * _LANES - T
    tp = tbl.astype(I32)
    if pad:
        tp = jnp.concatenate(
            [tp, jnp.zeros((B, pad), I32)], axis=-1
        )
    tr = tp.reshape(B, dh, _LANES)
    ic = jnp.clip(idx.astype(I32), 0, dh * _LANES - 1)
    if valid is not None:
        ic = jnp.where(valid, ic, jnp.int32(-1))
    ih = ic // _LANES
    a = (
        ih[..., None] == jnp.arange(dh, dtype=I32)
    )  # [B, N, dh] bool (kept bool: used as a select mask)
    b2 = (
        (ic % _LANES)[..., None] == jnp.arange(_LANES, dtype=I32)
    ).astype(BF16)
    nbytes = max(1, -(-max(1, (max_val - 1)).bit_length() // 8))
    out = jnp.zeros(idx.shape, I32)
    for by in range(nbytes):
        plane = ((tr >> (8 * by)) & 0xFF).astype(BF16)
        p = jax.lax.dot_general(
            b2, plane,
            dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # [B, N, dh]
        sel = jnp.sum(jnp.where(a, p, 0.0), axis=-1).astype(I32)
        out = out | (sel << (8 * by))
    return out


def mxu_gather_planes(tables, idx):
    """Gather MANY tables at ONE shared index: out[k][b, n] =
    tables[k][0][b, idx[b, n]] — the one-hot operands are built once
    and all tables' byte-planes ride a single lane-concatenated matmul.

    tables: list of ([B, T] integer array, nbytes) pairs — nbytes
    byte-planes cover that table's value range. idx: [B, N], CLAMPED to
    the 128-padded table bound: an index in T..TP-1 reads 0, one past
    TP-1 reads element TP-1 (a real element when T % 128 == 0), so
    callers pre-clip.

    Exact: each dot output cell has exactly ONE nonzero term (the
    full-width one-hot selects one table column), and every byte value
    <= 255 is bf16-exact. Cost ~ one [B, N, TP] x [B, S, TP] matmul
    with S = total byte-planes — built for the devbuild's p-space ->
    v-space plane transport (dq/SE bands), where per-plane gathers or a
    rank scatter pay per plane."""
    B, T = tables[0][0].shape
    TP = -(-T // _LANES) * _LANES
    pad = TP - T
    ic = jnp.clip(idx.astype(I32), 0, TP - 1)
    # FULL-width one-hot (no dh factorization): the factorized form's
    # [B, N, S*dh] partials cost dh x the useful data in traffic plus a
    # select pass; at the plane-transport shapes (T ~ 1k, S ~ 150) the
    # single wide one-hot is cheaper end-to-end.
    b_full = (
        ic[..., None] == jnp.arange(TP, dtype=I32)
    ).astype(BF16)  # [B, N, TP]
    subs = []  # (table_idx, byte) per subplane, in lane-concat order
    planes = []
    for k, (tbl, nbytes) in enumerate(tables):
        tp = tbl.astype(I32)
        if pad:
            tp = jnp.concatenate(
                [tp, jnp.zeros((B, pad), I32)], axis=-1
            )
        for by in range(nbytes):
            subs.append((k, by))
            planes.append(((tp >> (8 * by)) & 0xFF).astype(BF16))
    stacked = jnp.stack(planes, axis=1)  # [B, S, TP]
    sel = jax.lax.dot_general(
        b_full, stacked,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=BF16,  # exact: single nonzero, <= 255
    ).astype(I32)  # [B, N, S]
    out = [jnp.zeros(idx.shape, I32) for _ in tables]
    for j, (k, by) in enumerate(subs):
        out[k] = out[k] | (sel[:, :, j] << (8 * by))
    return out


def hist_lohi(values, valid, D, *, chunk: int = 4096):
    """(lo, hi) over the FULL grid 0..D-1: lo[d] = #{v < d},
    hi[d] = #{v <= d}. Replaces `sort + searchsorted(arange(D))`
    (`_row_ss_lr` on a full-grid query) with hist + cumsum."""
    h = mxu_hist(values, valid, D, chunk=chunk)
    hi = jnp.cumsum(h, axis=-1, dtype=I32)
    lo = hi - h
    return lo, hi


def mxu_scatter(ranks, valid, payloads, D, *, chunk: int = 4096,
                max_payload: int = 1 << 16):
    """Transport payloads to known destination ranks (sort-free
    "scatter"): out[b, ranks[b, n]] = payloads[k][b, n].

    Requires ranks unique among valid rows (a permutation /
    compaction) — each output cell then receives exactly one nonzero
    term, so the f32 result is the payload bit-exactly. Payloads are
    byte-split so every bf16 factor is an exact small integer.

    payloads: tuple of [B, N] integer arrays in [0, max_payload).
    Returns tuple of [B, D] i32 (cells with no source read 0)."""
    B, N = ranks.shape
    dh = -(-D // _LANES)
    nbytes = max(1, -(-(max_payload - 1).bit_length() // 8))
    r = jnp.where(valid, ranks.astype(I32), jnp.int32(-1))
    rc = _pad_chunks(r, chunk, -1)
    pc = [
        _pad_chunks(p.astype(I32), chunk, 0) for p in payloads
    ]
    nc = rc.shape[1]
    NP = len(payloads)

    def step(acc, xs):
        vals = xs[0]
        a, bm = _factor_onehots(vals, dh)
        # stack payload bytes along the lane axis: one matmul moves
        # every byte of every payload.
        cols = []
        for p in xs[1:]:
            for by in range(nbytes):
                cols.append(bm * ((p >> (8 * by)) & 0xFF).astype(BF16)[..., None])
        rhs = jnp.concatenate(cols, axis=-1)  # [B, Nc, NP*nbytes*128]
        return acc + _matmul_acc(a, rhs), None

    acc0 = jnp.zeros((B, dh, NP * nbytes * _LANES), jnp.float32)
    if nc == 1:
        acc, _ = step(acc0, (rc[:, 0],) + tuple(p[:, 0] for p in pc))
    else:
        acc, _ = jax.lax.scan(
            step,
            acc0,
            (jnp.moveaxis(rc, 1, 0),)
            + tuple(jnp.moveaxis(p, 1, 0) for p in pc),
        )
    out = []
    for k in range(NP):
        tot = jnp.zeros((B, dh * _LANES), I32)
        for by in range(nbytes):
            sl = acc[:, :, (k * nbytes + by) * _LANES:
                     (k * nbytes + by + 1) * _LANES]
            tot = tot + (
                sl.reshape(B, dh * _LANES).astype(I32) << (8 * by)
            )
        out.append(tot[:, :D])
    return tuple(out)


def mxu_scatter_presence(ranks, valid, D, *, chunk: int = 4096):
    """Presence indicator at unique ranks: out[b, d] = 1 iff some valid
    n has ranks[b, n] == d. One histogram, no payload."""
    return mxu_hist(ranks, valid, D, chunk=chunk)
