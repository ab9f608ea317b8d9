"""Blocked max-plus consensus DP: O(sqrt(V)) sequential depth, bit-exact,
computed in int32 half-units.

The direct reverse scan (`dp.dp_scores`) runs V sequential steps of tiny
work — latency-bound (each step is ~[B, W] elements). This module
reformulates the same recurrence as **max-plus linear algebra** so the
chain shortens to ~L + V/L + L steps of large dense work:

  state  x_u = [s[u], .., s[u+W-1], 0]  (affine max-plus vector)
  step   x_u = A_u (x) x_{u+1}          (companion-style band matrix;
                                         row 0 = [esc[u,:], e_exit[u]])

1. **Build** per-block transfer matrices M_g = A_{gL} (x) ... (x)
   A_{gL+L-1}: L sequential steps, all V/L blocks in parallel; each step
   is one max-plus row update (a (W+1)^2 tensor op over [B, G]).
2. **Propagate** boundary vectors sequentially through the V/L blocks
   (max-plus matrix-vector, trivial work).
3. **Fill** interior scores by running the direct recurrence inside
   every block simultaneously from its boundary vector (L steps of
   [B, G, W] work).

Bit-exactness (int32 formulation): every edge score in SPEC §2.6 is a
multiple of 0.5 (`count - 0.5*cov`, `-10`, `count`), so **doubling all
scores makes every value an integer** and max-plus reassociation is
exact by construction — integer adds never round. The algebra runs in
int32 "half-units" with a sentinel `SENT = -2^30` standing in for -inf:

- every stored value is clamped to `>= SENT`, so any pairwise sum is
  `>= 2*SENT = INT32_MIN` (exactly representable — no wraparound);
- `blocked_safe` bounds `V * 2*max|esc| < 2^28` host-side so (a) real
  path sums stay within +-2^28, (b) sentinel-contaminated values (SENT
  plus at most one solve's worth of accumulation, < 2^28 + 2L*maxesc)
  stay below `-2^29`, strictly separated from every real value. The
  bound is ~32x looser than the old f32 guard (`V*max|esc| < 2^22`) and
  admits the 100-500x-depth regime the blocked solve exists for.

Matching the f32 spec bit-for-bit: the reference arithmetic (SPEC §2.6)
is IEEE float32, which computes these half-integers exactly as long as
no intermediate exceeds 2^24 half-units. A posterior per-row check flags
rows where any finite score reaches `2^24 - 2^17` half-units (so every
f32 scan candidate `esc + score` provably fits too); flagged rows fold
into the unconverged mask and refetch through the exact sequential f32
scan. In practice path scores are ~depth x backbone_len half-units
(~10^6 at 500x on 1kb) — far below the flag line.

Long edges (span > W) break the banded structure, so they are resolved
by monotone Kleene iteration: solve the band system, then check each
long edge's candidate `lesc + s[w] > s[u]`; if none is active the band
solution IS the full solution (induction from the topological end — the
first differing node would need an active long edge). Active targets
re-solve with the long candidates injected as constants, converging
from below to the exact fixed point; bitwise-stable iteration ends the
loop (sequential-scan fallback after `max_iters`). Only candidates above
the real/contaminated separation line are injected, so contamination
never re-accumulates across iterations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = np.float32(-np.inf)
# Sentinel for "no path" in half-units. Clamping every stored value to
# >= SENT keeps any pairwise sum >= INT32_MIN (no wraparound).
SENT = np.int32(-(1 << 30))
# Real scores are > -2^29 by the blocked_safe bound; anything at or
# below is sentinel-contaminated and decodes to -inf.
_REAL_MIN = np.int32(-(1 << 29))
# Posterior f32-parity line: all finite half-unit scores must stay under
# 2^24 - 2^17 so the f32 scan's candidates (score + esc, |2*esc| < 2^17)
# are exactly representable too.
_F32_LIMIT = np.int32((1 << 24) - (1 << 17))
_PENALTY2 = np.int32(-20)  # -10.0 in half-units


def _esc2_dense(win_count, exit_count, cov, unsup):
    """esc2[b,u,d] int32 (half-units) and e_exit2[b,u] int32."""
    B, V, W = win_count.shape
    wc = win_count.astype(jnp.int32)
    idx = (
        jnp.arange(V, dtype=jnp.int32)[:, None]
        + 1
        + jnp.arange(W, dtype=jnp.int32)[None, :]
    )  # [V, W] target node ids
    idx = jnp.minimum(idx, V - 1)
    cov_w = jnp.take(cov.astype(jnp.int32), idx, axis=1)  # [B, V, W]
    unsup_w = jnp.take(unsup, idx, axis=1)  # [B, V, W]
    esc2 = jnp.where(
        wc >= 0,
        jnp.where(unsup_w, _PENALTY2, 2 * wc - cov_w),
        SENT,
    )
    e_exit2 = jnp.where(
        exit_count >= 0, 2 * exit_count.astype(jnp.int32), SENT
    )
    return esc2, e_exit2


@functools.partial(jax.jit, static_argnames=("L",))
def _solve_band(esc2, e_exit2, L=64):
    """Exact banded solve via blocked int32 max-plus; returns half-unit
    scores [B, V] int32 (sentinel-contaminated where unreachable)."""
    B, V, W = esc2.shape
    assert V % L == 0
    G = V // L
    Wp = W + 1

    # a[b, u, :] = [esc row, e_exit] — row 0 of A_u.
    a = jnp.concatenate([esc2, e_exit2[..., None]], axis=-1)  # [B, V, Wp]
    a_blk = a.reshape(B, G, L, Wp)

    # ---- Phase 1: block transfer matrices.
    eye = jnp.full((Wp, Wp), SENT, jnp.int32)
    eye = eye.at[jnp.arange(Wp), jnp.arange(Wp)].set(0)
    M0 = jnp.broadcast_to(eye, (B, G, Wp, Wp))

    def compose(M, t):
        at = a_blk[:, :, L - 1 - t, :]  # [B, G, Wp]
        row0 = jnp.maximum(
            jnp.max(at[..., :, None] + M, axis=-2), SENT
        )  # [B, G, Wp]
        M = jnp.concatenate(
            [row0[..., None, :], M[..., 0 : W - 1, :], M[..., W:Wp, :]],
            axis=-2,
        )
        return M, None

    M, _ = jax.lax.scan(compose, M0, jnp.arange(L, dtype=jnp.int32))

    # ---- Phase 2: boundary vectors, sequential over blocks (reverse).
    x_init = jnp.full((B, Wp), SENT, jnp.int32).at[:, W].set(0)

    def prop(x, Mg):
        # Mg: [B, Wp, Wp]; x entering = boundary of the NEXT block.
        x_out = jnp.maximum(
            jnp.max(Mg + x[:, None, :], axis=-1), SENT
        )  # [B, Wp]
        return x_out, x  # emit the incoming boundary (block g's input)

    _, x_in = jax.lax.scan(
        prop, x_init, jnp.moveaxis(M, 1, 0), reverse=True
    )  # x_in[g] = x_{(g+1)L}  [G, B, Wp]
    x_in = jnp.moveaxis(x_in, 0, 1)  # [B, G, Wp]

    # ---- Phase 3: interior fill, all blocks in parallel.
    win0 = x_in[..., :W]  # [B, G, W] score windows below each block

    def fill(win, t):
        at = a_blk[:, :, L - 1 - t, :]  # [B, G, Wp]
        s = jnp.maximum(
            jnp.max(
                jnp.concatenate([at[..., :W] + win, at[..., W:]], axis=-1),
                axis=-1,
            ),
            SENT,
        )  # [B, G]
        win = jnp.concatenate([s[..., None], win[..., : W - 1]], axis=-1)
        return win, s

    _, ys = jax.lax.scan(fill, win0, jnp.arange(L, dtype=jnp.int32))
    # ys[t, b, g] = s[gL + (L-1-t)] -> reorder to [B, V].
    ys = jnp.moveaxis(ys, 0, 2)  # [B, G, L] with L axis reversed
    return ys[:, :, ::-1].reshape(B, V)


@functools.partial(jax.jit, static_argnames=("L", "max_iters"))
def dp_scores_blocked(
    win_count: jax.Array,  # [B, V, W] int16/int32
    exit_count: jax.Array,  # [B, V] int16/int32
    cov: jax.Array,  # [B, V] int16/int32
    unsup: jax.Array,  # [B, V] bool
    long_u: jax.Array,  # [B, K] int32 (-1 pad)
    long_w: jax.Array,  # [B, K] int32
    long_esc: jax.Array,  # [B, K] float32
    L: int = 64,
    max_iters: int = 8,
) -> tuple[jax.Array, jax.Array]:
    """Blocked int32 DP with long-edge Kleene iteration.

    Returns (scores [B, V] f32, fallback [B] bool). Flagged rows —
    still-active long edges after `max_iters`, or finite scores beyond
    the f32-parity line — must take the sequential f32 scan; exactness
    to the f32 spec is never silently sacrificed."""
    B, V, W = win_count.shape
    esc2, e_exit2 = _esc2_dense(win_count, exit_count, cov, unsup)
    valid = long_u >= 0
    lu = jnp.where(valid, long_u, 0)
    lw = jnp.where(valid, long_w, 0)
    fin = valid & jnp.isfinite(long_esc)
    # long_esc values are half-integers well inside f32-exact range;
    # doubling is exact.
    lesc2 = jnp.where(
        fin, jnp.where(fin, long_esc * 2.0, 0.0).astype(jnp.int32), SENT
    )  # [B, K]

    def body(state):
        _s, e_ex, it, _active = state
        s = _solve_band(esc2, e_ex, L=L)
        cand = jnp.maximum(
            lesc2 + jnp.take_along_axis(s, lw, axis=1), SENT
        )  # [B, K]
        # Only real candidates may activate: contaminated values (below
        # _REAL_MIN) are conceptually -inf, and injecting them would let
        # sentinel drift accumulate across Kleene iterations.
        active = (cand > jnp.take_along_axis(s, lu, axis=1)) & (
            cand > _REAL_MIN
        )
        # Inject active candidates as constants for the next round
        # (monotone: keep previous injections via max with e_ex).
        extra = jnp.full((B, V), SENT, jnp.int32)
        extra = extra.at[
            jnp.arange(B)[:, None], lu
        ].max(jnp.where(active, cand, SENT))
        e_ex_next = jnp.maximum(e_ex, extra)
        return s, e_ex_next, it + 1, jnp.any(active, axis=1)

    def cond(state):
        _s, _e, it, active = state
        return jnp.logical_and(it < max_iters, jnp.any(active))

    s0 = jnp.zeros((B, V), jnp.int32)
    state = (s0, e_exit2, jnp.int32(0), jnp.ones((B,), bool))
    state = jax.lax.while_loop(cond, body, state)
    s2, _e, it, active = state

    finite = s2 > _REAL_MIN
    # int32 -> f32 in half-units is exact below the parity line; rows
    # with any finite score at/past it are flagged for the f32 scan.
    scores = jnp.where(finite, s2.astype(jnp.float32) * 0.5, NEG_INF)
    overflow = jnp.any(finite & (jnp.abs(s2) >= _F32_LIMIT), axis=1)
    return scores, active | overflow


def blocked_safe(max_abs_esc: float, v: int) -> bool:
    """True if the int32 blocked algebra is safe for this batch: real
    path sums bounded by `v * 2*max|esc| < 2^28` half-units, keeping
    (a) int32 far from overflow and (b) sentinel-contaminated values
    strictly below every real score (see module docstring). `max_abs_esc`
    is in score units (f32 halves), as callers already compute it."""
    return v * max(abs(max_abs_esc), 10.0) < float(1 << 27)
