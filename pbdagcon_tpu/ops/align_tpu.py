"""Batched pairwise alignment on device (device SimpleAligner).

Device version of SPEC.md §1.5's banded global aligner — the hot stage
of the `-a`/dazcon paths (re-aligning every read against its target,
SURVEY.md §3.2's dazcon hot loop). Exactly reproduces
`pbdagcon_tpu.aligner.align_pair` for every pair; fuzz tests enforce
byte equality.

Formulation (device-friendly, mathematically identical):

- **Offset-space band.** Lane `k` of row `i` holds column
  `j = i + dmin + k`, so the diagonal predecessor is the *same lane* of
  the previous row and the up predecessor is lane `k+1` — no per-row
  shifting. The window `[dmin, dmax]` covers every pair's scaled-
  diagonal band (`|i - j*m/n| <= bw`); cells outside a pair's true band
  are masked to -inf each row, which keeps banded-DP semantics exact.
- **Left chains as a scan.** With linear gaps, the in-row dependency
  `H[i][j] = max(cand[j], H[i][j-1] - 3)` unrolls to
  `max_{j'<=j} cand[j'] - 3(j-j')` — a running max of `cand + 3*lane`
  (integer `cummax`, exact). The `j = 0` boundary (`-3i`) seeds the
  chain. Out-of-band lanes leak only all-gap floor values, which never
  exceed any banded path score, so values and traceback pointers match
  the sequential reference bit for bit (argued inline below).
- Each row emits 2-bit traceback pointers with the reference priority
  (diagonal > up > left); the host walks them to build the gapped
  strings (borders handled without pointers).

The scan runs `M` steps of `[B, Wa]` integer VPU work — batch on lanes,
one `lax.dynamic_slice` of the target bytes per row (contiguous, since
offset-space makes the row's target window `tb[i+dmin : i+dmin+Wa]`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pbdagcon_tpu.aligner import GAP, MATCH, MISMATCH, band_halfwidth

NEG = np.int32(-(1 << 30))


@functools.partial(jax.jit, static_argnames=("M", "Wa", "dmin", "L"))
def _traceback_scan(
    packed: jax.Array,  # [B, M, Wa//4] uint8 (2-bit pointers, device)
    m: jax.Array,  # [B]
    n: jax.Array,  # [B]
    M: int,
    Wa: int,
    dmin: int,
    L: int,
):
    """Walk the pointers on device, emitting a per-pair move stream
    (0=diag, 1=up, 2=left, 3=done) of static length L >= max(m+n).

    The pointer tensor is ~M*Wa/4 bytes/pair — far too big for the slow
    device->host link; the move stream is ~(m+n) bytes/pair."""
    B = packed.shape[0]
    Wa4 = Wa // 4
    flat = packed.reshape(B, M * Wa4)

    def step(state, _):
        i, j = state
        done = (i == 0) & (j == 0)
        lane = j - i - jnp.int32(dmin)
        lin = (jnp.maximum(i - 1, 0)) * Wa4 + jnp.clip(
            lane >> 2, 0, Wa4 - 1
        )
        byte = jnp.take_along_axis(flat, lin[:, None], axis=1)[:, 0]
        p = (byte >> (2 * (lane & 3)).astype(jnp.uint8)) & 3
        p = jnp.where(i == 0, jnp.uint8(2), p.astype(jnp.uint8))
        p = jnp.where((j == 0) & (i > 0), jnp.uint8(1), p)
        p = jnp.where(done, jnp.uint8(3), p)
        i = i - ((p == 0) | (p == 1)).astype(jnp.int32)
        j = j - ((p == 0) | (p == 2)).astype(jnp.int32)
        return (i, j), p

    (_, _), moves = jax.lax.scan(
        step, (m.astype(jnp.int32), n.astype(jnp.int32)), None, length=L
    )
    return jnp.moveaxis(moves, 0, 1)  # [B, L]


@functools.partial(jax.jit, static_argnames=("M", "Wa", "dmin"))
def _align_scan(
    qb: jax.Array,  # [B, M] uint8 query bytes (0 pad)
    tb_pad: jax.Array,  # [B, N + Wa + 2] uint8, target bytes at offset
    m: jax.Array,  # [B] int32 true query lengths
    n: jax.Array,  # [B] int32 true target lengths
    bw: jax.Array,  # [B] int32 per-pair band half-width
    M: int,
    Wa: int,
    dmin: int,
):
    B = qb.shape[0]
    lanes = jnp.arange(Wa, dtype=jnp.int32)  # [Wa]
    ramp = jnp.int32(-GAP) * lanes  # +3 * lane

    # Row 0: H[0][j] = GAP * j for 0 <= j <= n.
    j0 = jnp.int32(dmin) + lanes  # j at row 0
    H0 = jnp.where(
        (j0 >= 0) & (j0 <= n[:, None]),
        jnp.int32(GAP) * j0,
        NEG,
    ).astype(jnp.int32)

    def step(H_prev, i):
        # Row i (1-based). Lane k -> column j = i + dmin + k.
        j = i + jnp.int32(dmin) + lanes  # [Wa]
        jb = jnp.broadcast_to(j, (B, Wa))
        # Target bytes t[j-1]: contiguous window starting at i+dmin-1.
        start = i + jnp.int32(dmin) - 1 + jnp.int32(1 - dmin)  # index in tb_pad
        trow = jax.lax.dynamic_slice(
            tb_pad, (jnp.int32(0), start), (B, Wa)
        )  # [B, Wa] = t[j-1] (pad bytes are 0: never equal to ACGT)
        qrow = jnp.take_along_axis(
            qb, jnp.minimum(i - 1, qb.shape[1] - 1)[None, None].astype(jnp.int32)
            * jnp.ones((B, 1), jnp.int32), axis=1
        )  # [B, 1] = q[i-1]
        sub = jnp.where(qrow == trow, jnp.int32(MATCH), jnp.int32(MISMATCH))

        diag_cand = H_prev + sub  # same lane
        up_prev = jnp.concatenate(
            [H_prev[:, 1:], jnp.full((B, 1), NEG, jnp.int32)], axis=1
        )
        up_cand = up_prev + jnp.int32(GAP)
        tmp = jnp.maximum(diag_cand, up_cand)

        # Reference band validity for this row: 1<=j<=n, |i - j*m/n|<=bw
        # via center c = i*n//m (guard i<=m).
        c = jnp.where(m > 0, (i * n) // jnp.maximum(m, 1), 0)  # [B]
        valid = (
            (jb >= 1)
            & (jb <= n[:, None])
            & (jb >= (c - bw)[:, None])
            & (jb <= (c + bw)[:, None])
            & (i <= m)[:, None]
        )
        tmp = jnp.where(valid, tmp, NEG)
        # j == 0 boundary seeds the left chain with GAP * i.
        tmp = jnp.where(jb == 0, jnp.int32(GAP) * i, tmp)

        # Left chains: running max of tmp + 3*lane (exact, integer).
        cm = jax.lax.cummax(tmp + ramp, axis=1)
        H_row = cm - ramp

        # Traceback pointer, reference priority diag > up > left.
        ptr = jnp.where(
            H_row == diag_cand,
            jnp.uint8(0),
            jnp.where(H_row == up_cand, jnp.uint8(1), jnp.uint8(2)),
        )
        # Mask out-of-band lanes (keep the j==0 boundary column).
        H_row = jnp.where(valid | (jb == 0), H_row, NEG)
        return H_row, ptr

    _, ptrs = jax.lax.scan(
        step, H0, jnp.arange(1, M + 1, dtype=jnp.int32)
    )
    ptrs = jnp.moveaxis(ptrs, 0, 1)  # [B, M, Wa]
    # 2-bit pack (4 pointers/byte): the device->host link is slow, and
    # the pointer tensor is the only fetch of the batch.
    p = ptrs.reshape(ptrs.shape[0], M, Wa // 4, 4)
    packed = (
        p[..., 0]
        | (p[..., 1] << 2)
        | (p[..., 2] << 4)
        | (p[..., 3] << 6)
    )
    return packed  # [B, M, Wa//4] uint8


def align_batch(pairs: list[tuple[str, str]]) -> list[tuple[str, str]]:
    """Align many (q, t) pairs on device; bit-equal to `align_pair`."""
    if not pairs:
        return []
    out: list[tuple[str, str] | None] = [None] * len(pairs)
    # Trivial empties on host.
    todo: list[int] = []
    for i, (q, t) in enumerate(pairs):
        if not q:
            out[i] = ("-" * len(t), t)
        elif not t:
            out[i] = (q, "-" * len(q))
        else:
            todo.append(i)
    if not todo:
        return [o for o in out]  # type: ignore[misc]

    ms = np.array([len(pairs[i][0]) for i in todo], dtype=np.int32)
    ns = np.array([len(pairs[i][1]) for i in todo], dtype=np.int32)
    bws = np.array(
        [band_halfwidth(int(a), int(b)) for a, b in zip(ms, ns)],
        dtype=np.int32,
    )
    B = len(todo)
    # Quantize the static kernel shape (M, Wa, dmin) so batches with
    # similar geometry share one compiled executable.
    M = -(-int(ms.max()) // 256) * 256
    N = int(ns.max())
    dmin = int(min(0, (ns - ms).min()) - bws.max()) - 1
    dmin = -(-(-dmin) // 64) * -64  # round away from zero to 64s
    dmax = int(max(0, (ns - ms).max()) + bws.max()) + 1
    Wa = dmax - dmin + 1
    Wa = -(-Wa // 128) * 128

    # Pad the batch dim to a ladder so dispatches share compiled shapes.
    Bp = next((b for b in (32, 64, 128, 256, 512, 1024, 2048) if b >= B), B)
    ms = np.concatenate([ms, np.ones(Bp - B, np.int32)])
    ns = np.concatenate([ns, np.ones(Bp - B, np.int32)])
    bws = np.concatenate([bws, np.full(Bp - B, 64, np.int32)])
    qb = np.zeros((Bp, M), dtype=np.uint8)
    # Row i slices tb_pad[i : i+Wa]; size must cover i=M plus the t
    # placement offset (1 - dmin) so dynamic_slice never clamps.
    tb_pad = np.zeros((Bp, max(M, N + 1 - dmin) + Wa + 2), dtype=np.uint8)
    for k, i in enumerate(todo):
        q, t = pairs[i]
        qb[k, : len(q)] = np.frombuffer(q.encode(), np.uint8)
        # t[j-1] window at lane k of row i starts at tb_pad index
        # (i + dmin - 1) + (1 - dmin); store t so t[x] sits at x+1-dmin.
        tb_pad[k, 1 - dmin : 1 - dmin + len(t)] = np.frombuffer(
            t.encode(), np.uint8
        )

    packed_dev = _align_scan(
        jnp.asarray(qb), jnp.asarray(tb_pad), jnp.asarray(ms),
        jnp.asarray(ns), jnp.asarray(bws), M=M, Wa=Wa, dmin=dmin,
    )
    # Device-side traceback: fetch only the ~(m+n)-byte move streams
    # (the pointer tensor itself is ~M*Wa/4 bytes/pair — 30-50x more).
    Np = -(-N // 256) * 256
    L = M + Np
    moves = np.asarray(
        _traceback_scan(
            packed_dev, jnp.asarray(ms), jnp.asarray(ns),
            M=M, Wa=Wa, dmin=dmin, L=L,
        )
    )

    # Fully vectorized replay across the batch: reverse each row by its
    # own path length, cumsum-index into concatenated sequence buffers,
    # then slice out per-pair strings.
    Bt = len(todo)
    mv = moves[:Bt]  # [Bt, L]
    has_done = (mv == 3).any(axis=1)
    plen = np.where(has_done, np.argmax(mv == 3, axis=1), mv.shape[1])
    pos = np.arange(mv.shape[1])[None, :]
    rev_idx = np.clip(plen[:, None] - 1 - pos, 0, mv.shape[1] - 1)
    fwd = np.take_along_axis(mv, rev_idx, axis=1)  # forward-order moves
    inpath = pos < plen[:, None]
    take_q = (fwd != 2) & inpath
    take_t = (fwd != 1) & inpath

    qcat = np.frombuffer(
        "".join(pairs[i][0] for i in todo).encode(), np.uint8
    )
    tcat = np.frombuffer(
        "".join(pairs[i][1] for i in todo).encode(), np.uint8
    )
    qoff = np.zeros(Bt, np.int64)
    toff = np.zeros(Bt, np.int64)
    np.cumsum(ms[:Bt][:-1], out=qoff[1:])
    np.cumsum(ns[:Bt][:-1], out=toff[1:])
    qi = np.cumsum(take_q, axis=1) - 1 + qoff[:, None]
    ti = np.cumsum(take_t, axis=1) - 1 + toff[:, None]
    gap = np.uint8(ord("-"))
    qs2 = np.where(take_q, qcat[np.clip(qi, 0, len(qcat) - 1)], gap)
    ts2 = np.where(take_t, tcat[np.clip(ti, 0, len(tcat) - 1)], gap)
    for k, i in enumerate(todo):
        L = int(plen[k])
        out[i] = (
            qs2[k, :L].tobytes().decode(),
            ts2[k, :L].tobytes().decode(),
        )
    return [o for o in out]  # type: ignore[misc]
