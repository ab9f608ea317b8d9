"""Batched device consensus DP: reverse banded max-plus scan + long-edge
register file.

The reference's `AlnGraphBoost::consensus()` scores nodes in reverse
topological order with a per-out-edge max (reconstructed
`src/cpp/AlnGraphBoost.cpp`, SURVEY.md §3.4; SPEC.md §2.6). After
linearization, edge spans are strongly banded (p99 of spans is tens) but
node-merging across convergence points (e.g. every read's trailing
insertion merging before exit) produces a few arbitrarily long edges per
target. The DP therefore splits edges into:

- **band**: span <= W, stored dense as `win_count[B, V, W]`, scored on
  the fly from rolling attribute windows;
- **long edges**: up to K per target, `(u, w, esc)` triples. The reverse
  scan processes `w` before `u`, so when the scan emits `score[w]` it
  latches `esc + score[w]` into a per-edge pending register, and when it
  reaches `u` it folds all pending registers with `u_k == u` into the
  max. Exactness is unaffected — same float32 candidates, and f32 max is
  exact — so scores remain bitwise equal to the oracle's.

Edges into the virtual exit node (score 0) are a separate dense lane
(`esc_exit[B, V]`). Targets with more than K long edges fall back to the
host engine (never wrong, just slower; SPEC.md §3.1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pbdagcon_tpu.ops.linearize import LinearGraph

NEG_INF = np.float32(-np.inf)
_PENALTY = np.float32(-10.0)


@functools.partial(jax.jit, static_argnames=("unroll",))
def dp_scores(
    win_count: jax.Array,  # [B, V, W] int32, -1 = no edge
    exit_count: jax.Array,  # [B, V] int32, -1 = no edge
    cov: jax.Array,  # [B, V] int32
    unsup: jax.Array,  # [B, V] bool
    long_u: jax.Array,  # [B, K] int32, -1 = unused slot
    long_w: jax.Array,  # [B, K] int32
    long_esc: jax.Array,  # [B, K] float32 (esc precomputed host-side)
    unroll: int = 8,
) -> jax.Array:
    """Reverse max-plus scan over node index; returns scores [B, V] f32."""
    B, V, W = win_count.shape
    win_count = win_count.astype(jnp.int32)
    exit_count = exit_count.astype(jnp.int32)

    # Edge scores into exit: exit is backbone/weight-0/coverage-0, so
    # esc = float(count) (SPEC §2.6).
    esc_exit = jnp.where(
        exit_count >= 0, exit_count.astype(jnp.float32), NEG_INF
    )  # [B, V]

    xs = (
        jnp.swapaxes(win_count, 0, 1),  # [V, B, W]
        jnp.moveaxis(esc_exit, 1, 0),  # [V, B]
        jnp.moveaxis(cov.astype(jnp.float32), 1, 0),  # [V, B]
        jnp.moveaxis(unsup, 1, 0),  # [V, B]
        jnp.arange(V, dtype=jnp.int32),  # node index
    )

    init = (
        jnp.full((B, W), NEG_INF, dtype=jnp.float32),  # score window
        jnp.zeros((B, W), dtype=jnp.float32),  # cov window
        jnp.zeros((B, W), dtype=jnp.bool_),  # unsup window
        jnp.full(long_u.shape, NEG_INF, dtype=jnp.float32),  # pending
    )

    def step(carry, x):
        score_win, cov_win, unsup_win, pend = carry
        wc, e_exit, cov_u, unsup_u, i = x
        esc = jnp.where(
            wc >= 0,
            jnp.where(
                unsup_win,
                _PENALTY,
                wc.astype(jnp.float32) - 0.5 * cov_win,
            ),
            NEG_INF,
        )  # [B, W]
        s = jnp.max(esc + score_win, axis=-1)  # [B]
        s = jnp.maximum(s, e_exit)
        # Fold long edges leaving node i.
        extra = jnp.max(
            jnp.where(long_u == i, pend, NEG_INF), axis=-1
        )  # [B]
        s = jnp.maximum(s, extra)
        # Latch long edges arriving at node i: cand = esc + score[i].
        pend = jnp.where(long_w == i, long_esc + s[:, None], pend)
        new_score = jnp.concatenate([s[:, None], score_win[:, :-1]], axis=1)
        new_cov = jnp.concatenate([cov_u[:, None], cov_win[:, :-1]], axis=1)
        new_unsup = jnp.concatenate(
            [unsup_u[:, None], unsup_win[:, :-1]], axis=1
        )
        return (new_score, new_cov, new_unsup, pend), s

    _, ys = jax.lax.scan(step, init, xs, reverse=True, unroll=unroll)
    return jnp.moveaxis(ys, 0, 1)  # [B, V]


# Packed-batch fields that feed the DP, in `dp_scores` argument order.
DP_KEYS = (
    "win_count", "exit_count", "cov", "unsup", "long_u", "long_w",
    "long_esc",
)


def _solve(args, V: int, solver: str):
    """(scores [B, V] f32, unconverged [B] bool or None) of one packed
    batch by `solver`: "blocked" or "scan"; both exact."""
    if solver == "blocked":
        from pbdagcon_tpu.ops.dp_blocked import dp_scores_blocked

        return dp_scores_blocked(*args, L=_blocked_L(V))
    return dp_scores(*args), None


def _packed_solve(args, V: int, solver: str):
    """`_solve` + wire compression; rows the blocked solve left
    unconverged are wire-flagged, so they refetch through the exact
    scan like compression-flagged ones."""
    s, unconv = _solve(args, V, solver)
    packed = _compress_scores(s)
    if unconv is not None:
        packed = packed.at[:, 2].set(
            jnp.where(unconv, jnp.int16(0), packed[:, 2])
        )
    return packed


class LongEdgeOverflow(ValueError):
    """Raised when a target has more than K long edges (host fallback)."""


def _edge_spans(lin: LinearGraph) -> np.ndarray:
    """Spans (w - u) of interior CSR edges (exit edges excluded)."""
    u_of_edge = np.repeat(
        np.arange(lin.n, dtype=np.int32), np.diff(lin.edge_off)
    )
    interior = lin.edge_tgt < lin.n
    return (lin.edge_tgt - u_of_edge)[interior], u_of_edge[interior]


def choose_layout(
    lins: list[LinearGraph],
    w_ladder: tuple[int, ...] = (16, 32, 64, 128),
    k_ladder: tuple[int, ...] = (8, 32, 128),
) -> tuple[int, int]:
    """Pick the (W, K) bucket minimizing per-node DP work `W + K`.

    For each candidate band width W, K is the smallest ladder entry
    covering the worst per-target long-edge count. Span statistics are
    cheap to compute host-side; depth/noise move the optimum (shallow
    pileups want W=16, 100-500x pileups want W=64..128)."""
    spans = [_edge_spans(lin)[0] for lin in lins]
    best: tuple[int, int] | None = None
    best_cost = None
    for W in w_ladder:
        worst = max((int((s > W).sum()) for s in spans), default=0)
        K = next((k for k in k_ladder if k >= worst), None)
        if K is None:
            continue
        # Host->device transfer is the scarce resource (the band tensor
        # is ~W int16/node); the K register file is compute-only and
        # cheap per slot. Weight accordingly.
        cost = 2 * W + K / 2
        if best_cost is None or cost < best_cost:
            best, best_cost = (W, K), cost
    if best is None:
        raise LongEdgeOverflow(
            "no (W, K) bucket fits; host fallback required"
        )
    return best


def pad_batch(
    lins: list[LinearGraph], V: int, W: int, K: int
) -> dict[str, np.ndarray]:
    """Pack linear graphs into padded batch arrays for `dp_scores`.

    Edges with span <= W go to the dense band; the rest become long-edge
    triples with host-precomputed esc. Raises `LongEdgeOverflow` if a
    target has more than K long edges, `ValueError` if n > V.
    """
    from pbdagcon_tpu.ops.linearize import edge_escores

    B = len(lins)
    # int16 wire format: merged edge counts and coverage are bounded by
    # pileup depth (<< 32767), and halving the band tensor halves the
    # dominant host->device transfer. Device casts to int32/f32.
    win = np.full((B, V, W), -1, dtype=np.int16)
    exit_c = np.full((B, V), -1, dtype=np.int16)
    cov = np.zeros((B, V), dtype=np.int16)
    uns = np.zeros((B, V), dtype=bool)
    lu = np.full((B, K), -1, dtype=np.int32)
    lw = np.full((B, K), -1, dtype=np.int32)
    lesc = np.full((B, K), NEG_INF, dtype=np.float32)
    n = np.zeros(B, dtype=np.int32)
    for b, lin in enumerate(lins):
        if lin.n > V:
            raise ValueError(f"target {lin.sid}: n={lin.n} > bucket V={V}")
        # int16 wire-format guards: edge counts can exceed per-column
        # coverage (merged boundary insertion nodes accumulate votes from
        # every read in the pileup), so check counts as well as cov.
        if (
            int(lin.cov.max(initial=0)) > 32000
            or int(lin.exit_count.max(initial=0)) > 32000
            or int(lin.edge_cnt.max(initial=0)) > 32000
        ):
            raise LongEdgeOverflow(
                f"target {lin.sid}: counts exceed int16 wire format"
            )
        interior = lin.edge_tgt < lin.n
        u_all = np.repeat(
            np.arange(lin.n, dtype=np.int32), np.diff(lin.edge_off)
        )
        u_e = u_all[interior]
        w_e = lin.edge_tgt[interior]
        c_e = lin.edge_cnt[interior]
        d = w_e - u_e - 1
        band = d < W
        win[b, u_e[band], d[band]] = c_e[band]
        nlong = int((~band).sum())
        if nlong > K:
            raise LongEdgeOverflow(
                f"target {lin.sid}: {nlong} > {K} long edges at W={W}"
            )
        if nlong:
            lu[b, :nlong] = u_e[~band]
            lw[b, :nlong] = w_e[~band]
            lesc[b, :nlong] = edge_escores(lin, w_e[~band], c_e[~band])
        exit_c[b, : lin.n] = lin.exit_count
        cov[b, : lin.n] = lin.cov
        uns[b, : lin.n] = lin.unsup
        n[b] = lin.n
    return {
        "win_count": win,
        "exit_count": exit_c,
        "cov": cov,
        "unsup": uns,
        "long_u": lu,
        "long_w": lw,
        "long_esc": lesc,
        "n": n,
    }


_B_LADDER = (8, 16, 32, 64, 128, 256, 512, 1024)


def _pad_b(batch: dict) -> dict:
    """Pad the batch dimension up to a ladder size so repeated dispatches
    share compiled shapes (row padding: no edges, scores ignored)."""
    B = batch["win_count"].shape[0]
    Bp = next((b for b in _B_LADDER if b >= B), B)
    if Bp == B:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "n" or k.startswith("_"):
            continue  # meta / host-only entries
        pad = np.zeros((Bp - B,) + v.shape[1:], dtype=v.dtype)
        if k in ("win_count", "exit_count", "long_u", "long_w"):
            pad[:] = -1
        elif k == "long_esc":
            pad[:] = NEG_INF
        out[k] = np.concatenate([v, pad], axis=0)
    return out


@jax.jit
def _compress_scores(s: jax.Array):
    """Delta-compress [B, V] f32 scores for the slow device->host link.

    Scores are exact multiples of 0.5 (SPEC §2.6 arithmetic), so the
    per-row stream (s[0], int16 deltas in half-units) reconstructs
    bitwise exactly — 2x less fetch traffic than raw f32. int16 (not
    int8): adjacent linear nodes routinely sit on different branches
    whose cumulative path scores differ by hundreds of half-units
    (measured p50 of per-row max |2*delta| is ~1100 on the bench
    workload), so int8 flagged ~every row and the fallback refetched
    full f32 scores, tripling fetch traffic. Rows where a delta
    overflows int16, is non-integral (f32 rounding kicked in), or where
    -inf appears outside a suffix (padding) are flagged and fetched
    individually by `_decode_packed`.
    """
    d2 = 2.0 * (s[:, :-1] - s[:, 1:])
    fin = jnp.isfinite(s)
    both = fin[:, :-1] & fin[:, 1:]
    d2 = jnp.where(both, d2, 0.0)
    h0 = 2.0 * s[:, 0]
    ok = (
        jnp.all(jnp.abs(d2) <= 32767.0, axis=1)
        & jnp.all(d2 == jnp.round(d2), axis=1)
        & fin[:, 0]
        & (h0 == jnp.round(h0))  # s[0] itself must be a half-integer
        & jnp.all(fin[:, :-1] | ~fin[:, 1:], axis=1)  # -inf only as suffix
    )
    # Batch-padding rows are all -inf; encode them as ok (whole-row
    # suffix from position 0) so they never trigger a fetch round trip.
    ok = ok | ~jnp.any(fin, axis=1)
    # Single-buffer int16 wire (one fetch round trip): per row, s[0]
    # bitcast to two int16, one ok flag, then V-1 int16 deltas.
    s0_i16 = jax.lax.bitcast_convert_type(
        s[:, 0:1], jnp.int16
    ).reshape(s.shape[0], 2)
    packed = jnp.concatenate(
        [s0_i16, ok[:, None].astype(jnp.int16), d2.astype(jnp.int16)],
        axis=1,
    )
    return packed


def _decode_packed(p: np.ndarray, fetch_rows) -> np.ndarray:
    """Reconstruct exact f32 scores from the int16 wire stream
    ([B, 3 + V-1]: s0 bitcast, ok flag, half-unit deltas). Rows whose
    compression was flagged are fetched individually via
    `fetch_rows(bad_indices) -> [len(bad), V] f32`."""
    ok = p[:, 2] != 0
    s0 = p[:, 0:2].copy().view(np.float32).reshape(-1)
    d = p[:, 3:]
    neg = ~np.isfinite(s0)  # all--inf padding rows (encoded ok)
    h0 = np.where(neg, 0.0, 2.0 * s0.astype(np.float64))
    h = h0.astype(np.int64)[:, None]
    h = h - np.cumsum(d.astype(np.int64), axis=1)
    s = np.empty((p.shape[0], d.shape[1] + 1), np.float32)
    s[:, 0] = s0
    s[:, 1:] = h.astype(np.float64) / 2.0
    if neg.any():
        s[neg] = s0[neg, None]
    if not ok.all():
        bad = np.nonzero(~ok)[0]
        s[bad] = fetch_rows(bad)
    return s


class _CompressedScores:
    """np.asarray()-able future that reconstructs exact scores from the
    packed stream (per-row device fetch for flagged rows)."""

    def __init__(self, s_dev, packed):
        self._s_dev = s_dev
        self._packed = packed

    def __array__(self, dtype=None, copy=None):
        s = _decode_packed(
            np.asarray(self._packed),
            lambda bad: np.asarray(self._s_dev[bad]),
        )
        return s if dtype is None else s.astype(dtype)


def arena_layout(B: int, V: int, W: int, K: int) -> dict:
    """Byte offsets of the single-buffer batch arena (one upload per
    dispatch — each separate host->device transfer pays a fixed cost).
    All offsets 4-byte aligned."""
    off = {}
    o = 0

    def take(name, nbytes):
        nonlocal o
        off[name] = (o, o + nbytes)
        o += -(-nbytes // 4) * 4  # keep 4-byte alignment

    take("win_count", B * V * W * 2)
    take("exit_count", B * V * 2)
    take("cov", B * V * 2)
    take("unsup", B * V)
    take("long_u", B * K * 4)
    take("long_w", B * K * 4)
    take("long_esc", B * K * 4)
    off["_total"] = o
    return off


def edges_layout(B: int, V: int, K: int, E: int, X: int) -> dict:
    """Byte offsets of the edge-CSR batch arena (upload is ~10x smaller
    than the dense band; the dense tensors are scatter-reconstructed on
    device). All offsets 4-byte aligned."""
    off = {}
    o = 0

    def take(name, nbytes):
        nonlocal o
        off[name] = (o, o + nbytes)
        o += -(-nbytes // 4) * 4

    take("eoff", (B + 1) * 4)
    take("ue", E * 2)
    take("de", E)
    take("ce", E * 2)
    take("xoff", (B + 1) * 4)
    take("xu", X * 2)
    take("xc", X * 2)
    take("cov", B * V * 2)
    take("unsup", B * V)
    take("long_u", B * K * 4)
    take("long_w", B * K * 4)
    take("long_esc", B * K * 4)
    off["_total"] = o
    return off


@functools.partial(
    jax.jit, static_argnames=("B", "V", "W", "K", "E", "X")
)
def _reconstruct_edges(
    arena: jax.Array, B: int, V: int, W: int, K: int, E: int, X: int
):
    """Unpack the CSR arena and scatter-build the dense arrays on
    device. Kept as its OWN small jit program (fast to compile) whose
    int16/bool outputs feed the already-compiled dense `dp_scores` and
    `_compress_scores` programs."""
    off = edges_layout(B, V, K, E, X)

    def u8(name):
        a, b = off[name]
        return jax.lax.slice(arena, (a,), (b,))

    def bc(name, dt, width, shape):
        x = u8(name).reshape(-1, width)
        return jax.lax.bitcast_convert_type(x, dt).reshape(shape)

    eoff = bc("eoff", jnp.int32, 4, (B + 1,))
    ue = bc("ue", jnp.int16, 2, (E,)).astype(jnp.int32)
    de = u8("de").astype(jnp.int32)
    ce = bc("ce", jnp.int16, 2, (E,)).astype(jnp.int32)
    xoff = bc("xoff", jnp.int32, 4, (B + 1,))
    xu = bc("xu", jnp.int16, 2, (X,)).astype(jnp.int32)
    xc = bc("xc", jnp.int16, 2, (X,)).astype(jnp.int32)
    cov = bc("cov", jnp.int16, 2, (B, V))
    unsup = u8("unsup").reshape(B, V) != 0
    long_u = bc("long_u", jnp.int32, 4, (B, K))
    long_w = bc("long_w", jnp.int32, 4, (B, K))
    long_esc = bc("long_esc", jnp.float32, 4, (B, K))

    # Edge -> batch row (stream positions past eoff[B] land on a dummy
    # extra row that is dropped after the scatter).
    pos = jnp.arange(E, dtype=jnp.int32)
    be = jnp.searchsorted(eoff, pos, side="right") - 1
    flat = jnp.full(((B + 1) * V * W,), -1, jnp.int16)
    flat = flat.at[(be * V + ue) * W + de].set(
        ce.astype(jnp.int16), unique_indices=True
    )
    win = flat.reshape(B + 1, V, W)[:B]

    posx = jnp.arange(X, dtype=jnp.int32)
    bx = jnp.searchsorted(xoff, posx, side="right") - 1
    xflat = jnp.full(((B + 1) * V,), -1, jnp.int16)
    xflat = xflat.at[bx * V + xu].set(
        xc.astype(jnp.int16), unique_indices=True
    )
    exit_c = xflat.reshape(B + 1, V)[:B]

    return win, exit_c, cov, unsup, long_u, long_w, long_esc


def _edges_to_scores(arena, B, V, W, K, E, X):
    dense = _reconstruct_edges(arena, B=B, V=V, W=W, K=K, E=E, X=X)
    return dp_scores(*dense)


def _dp_scores_edges(arena, B, V, W, K, E, X):
    return _compress_scores(
        _edges_to_scores(arena, B=B, V=V, W=W, K=K, E=E, X=X)
    )


def _dp_scores_edges_uncompressed(arena, B, V, W, K, E, X):
    return _edges_to_scores(arena, B=B, V=V, W=W, K=K, E=E, X=X)


def arena8_layout(B: int, V: int, W: int, K: int) -> dict:
    """int8 variant of `arena_layout`: counts/coverage fit int8 when the
    pileup depth is < 128 (the common case), halving the upload again."""
    off = {}
    o = 0

    def take(name, nbytes):
        nonlocal o
        off[name] = (o, o + nbytes)
        o += -(-nbytes // 4) * 4

    take("win_count", B * V * W)
    take("exit_count", B * V)
    take("cov", B * V)
    take("unsup", B * V)
    take("long_u", B * K * 4)
    take("long_w", B * K * 4)
    take("long_esc", B * K * 4)
    off["_total"] = o
    return off


def _squeeze_arena8(batch: dict) -> np.ndarray | None:
    """Build the int8 arena from an int16-packed batch, or None if any
    value exceeds int8 (depth >= 128).

    Edge counts can exceed coverage (merged identical leading/trailing
    insertion nodes accumulate votes from every read in the pileup, not
    just the reads spanning one backbone column), so the guard must check
    the counts themselves, not only `cov`.
    """
    if (
        int(batch["cov"].max(initial=0)) > 127
        or int(batch["win_count"].max(initial=0)) > 127
        or int(batch["exit_count"].max(initial=0)) > 127
    ):
        return None
    B, V, W = batch["win_count"].shape
    K = batch["long_u"].shape[1]
    off = arena8_layout(B, V, W, K)
    arena = np.zeros(off["_total"], dtype=np.uint8)

    def view(name, dtype, shape):
        a, b = off[name]
        return arena[a:b].view(dtype).reshape(shape)

    view("win_count", np.int8, (B, V, W))[:] = batch["win_count"]
    view("exit_count", np.int8, (B, V))[:] = batch["exit_count"]
    view("cov", np.int8, (B, V))[:] = batch["cov"]
    view("unsup", np.uint8, (B, V))[:] = batch["unsup"]
    view("long_u", np.int32, (B, K))[:] = batch["long_u"]
    view("long_w", np.int32, (B, K))[:] = batch["long_w"]
    view("long_esc", np.float32, (B, K))[:] = batch["long_esc"]
    return arena


def _unpack_arena8(arena: jax.Array, B: int, V: int, W: int, K: int):
    off = arena8_layout(B, V, W, K)

    def u8(name):
        a, b = off[name]
        return jax.lax.slice(arena, (a,), (b,))

    def as_i8(name, shape):
        return jax.lax.bitcast_convert_type(u8(name), jnp.int8).reshape(
            shape
        )

    def as_32(name, dt, shape):
        x = u8(name).reshape(-1, 4)
        return jax.lax.bitcast_convert_type(x, dt).reshape(shape)

    return (
        as_i8("win_count", (B, V, W)),
        as_i8("exit_count", (B, V)),
        as_i8("cov", (B, V)),
        u8("unsup").reshape(B, V) != 0,
        as_32("long_u", jnp.int32, (B, K)),
        as_32("long_w", jnp.int32, (B, K)),
        as_32("long_esc", jnp.float32, (B, K)),
    )


@functools.partial(
    jax.jit, static_argnames=("B", "V", "W", "K", "solver")
)
def _dp_scores_arena8(arena: jax.Array, B: int, V: int, W: int, K: int,
                      solver: str = "scan"):
    a = _unpack_arena8(arena, B, V, W, K)
    if solver == "blocked":
        a = tuple(x.astype(jnp.int16) for x in a[:3]) + a[3:]
    return _packed_solve(a, V, solver)


@functools.partial(jax.jit, static_argnames=("B", "V", "W", "K"))
def _dp_scores_arena8_full(arena: jax.Array, B: int, V: int, W: int, K: int):
    return dp_scores(*_unpack_arena8(arena, B, V, W, K))


def _unpack_arena(arena: jax.Array, B: int, V: int, W: int, K: int):
    off = arena_layout(B, V, W, K)

    def u8(name):
        a, b = off[name]
        return jax.lax.slice(arena, (a,), (b,))

    def as_i16(name, shape):
        x = u8(name).reshape(-1, 2)
        return jax.lax.bitcast_convert_type(x, jnp.int16).reshape(shape)

    def as_i32(name, shape):
        x = u8(name).reshape(-1, 4)
        return jax.lax.bitcast_convert_type(x, jnp.int32).reshape(shape)

    def as_f32(name, shape):
        x = u8(name).reshape(-1, 4)
        return jax.lax.bitcast_convert_type(x, jnp.float32).reshape(shape)

    return (
        as_i16("win_count", (B, V, W)),
        as_i16("exit_count", (B, V)),
        as_i16("cov", (B, V)),
        u8("unsup").reshape(B, V) != 0,
        as_i32("long_u", (B, K)),
        as_i32("long_w", (B, K)),
        as_f32("long_esc", (B, K)),
    )


@functools.partial(
    jax.jit, static_argnames=("B", "V", "W", "K", "solver")
)
def _dp_scores_arena(arena: jax.Array, B: int, V: int, W: int, K: int,
                     solver: str = "scan"):
    return _packed_solve(_unpack_arena(arena, B, V, W, K), V, solver)


def _blocked_L(V: int) -> int:
    """Block length: larger blocks at large V halve the sequential
    boundary chain AND the [B, G, Wp, Wp] transfer-matrix footprint."""
    return 128 if (V >= 8192 and V % 128 == 0) else 64


def _blocked_eligible(batch: dict, V: int) -> bool:
    """Host-side guard for routing an arena batch through the blocked
    solve: narrow bands only (the block algebra moves ~2*B*V*Wp^2*4
    bytes of transfer-matrix traffic regardless of L, ~W^2 work per node
    against the scan's W, so wide bands take the scan), a
    transfer-matrix footprint cap, and the int32 half-unit range bound
    (ops/dp_blocked.py) — ~32x looser than the old f32 guard, so
    narrow-band rungs stay eligible at any realistic depth."""
    B, _, W = batch["win_count"].shape
    L = _blocked_L(V)
    if V % L != 0 or W > 32:
        return False
    if B * (V // L) * (W + 1) ** 2 * 4 > (1 << 31):
        return False  # transfer-matrix footprint cap (~2 GB)
    from pbdagcon_tpu.ops.dp_blocked import blocked_safe

    max_esc = max(
        float(np.abs(batch["cov"]).max(initial=0)) * 0.5
        + float(batch["win_count"].max(initial=0)),
        10.0,
    )
    return bool(blocked_safe(max_esc, V))


def arena_solver(batch: dict, V: int) -> str:
    """DP solver for one packed xla-path batch: the blocked solve where
    `_blocked_eligible`, else the scan."""
    return "blocked" if _blocked_eligible(batch, V) else "scan"


def submit_arena_scores(
    arena: np.ndarray, B: int, V: int, W: int, K: int,
    solver: str = "scan",
) -> "jax.Array":
    """One-upload, one-dispatch, one-fetch DP: the arena holds the whole
    packed batch (see `arena_layout`); the result is the packed
    compressed-score buffer (`_CompressedScores`-compatible stream with
    no fallback handle — rows that fail compression, or that the blocked
    solve left unconverged, re-run via `dp_scores` on the arena)."""
    dev = jnp.asarray(arena)
    packed = _dp_scores_arena(dev, B=B, V=V, W=W, K=K, solver=solver)
    return _ArenaScores(dev, packed, B, V, W, K)


class _PackedFuture:
    """np.asarray()-able future over a packed compressed-score stream;
    `full_fn` produces the full-precision device scores for the rare
    flagged rows (fetched individually)."""

    def __init__(self, packed, full_fn):
        self._packed = packed
        self._full_fn = full_fn

    def __array__(self, dtype=None, copy=None):
        s = _decode_packed(
            np.asarray(self._packed),
            lambda bad: np.asarray(self._full_fn()[bad]),
        )
        return s if dtype is None else s.astype(dtype)


class _EdgesScores:
    """np.asarray()-able future over the CSR-arena DP result."""

    def __init__(self, arena_dev, packed, dims):
        self._arena = arena_dev
        self._packed = packed
        self._dims = dims

    def __array__(self, dtype=None, copy=None):
        def fetch_rows(bad):
            # Rare: rebuilding dense args on host is impossible here
            # (CSR only on device) — re-run the scan on device and
            # fetch the flagged rows for exactness.
            B, V, W, K, E, X = self._dims
            full = _dp_scores_edges_uncompressed(
                self._arena, B=B, V=V, W=W, K=K, E=E, X=X
            )
            return np.asarray(full[bad])

        s = _decode_packed(np.asarray(self._packed), fetch_rows)
        return s if dtype is None else s.astype(dtype)


def submit_edges_scores(
    arena: np.ndarray, B: int, V: int, W: int, K: int, E: int, X: int
):
    dev = jnp.asarray(arena)
    packed = _dp_scores_edges(dev, B=B, V=V, W=W, K=K, E=E, X=X)
    return _EdgesScores(dev, packed, (B, V, W, K, E, X))


class _ArenaScores:
    """np.asarray()-able future over the arena DP result."""

    def __init__(self, arena_dev, packed, B, V, W, K):
        self._arena = arena_dev
        self._packed = packed
        self._dims = (B, V, W, K)

    def __array__(self, dtype=None, copy=None):
        def fetch_rows(bad):
            B, V, W, K = self._dims
            args = _unpack_arena(self._arena, B, V, W, K)
            return np.asarray(dp_scores(*args)[bad])

        s = _decode_packed(np.asarray(self._packed), fetch_rows)
        return s if dtype is None else s.astype(dtype)


class _BlockedFuture:
    """Async result of the blocked DP; np.asarray() materializes it and
    transparently re-runs unconverged rows through the sequential scan
    (exactness is never sacrificed)."""

    def __init__(self, scores, unconv, args):
        self._scores = scores
        self._unconv = unconv
        self._args = args

    def __array__(self, dtype=None, copy=None):
        s = np.asarray(self._scores)
        u = np.asarray(self._unconv)
        if u.any():
            seq = np.asarray(dp_scores(*self._args))
            s = s.copy()
            s[u] = seq[u]
        return s if dtype is None else s.astype(dtype)


def submit_packed_scores(batch: dict, backend: str = "xla") -> jax.Array:
    """Dispatch the device DP on a packed batch (from `pad_batch` or the
    native `pack_batch`) asynchronously; materialize with np.asarray.
    The batch dim may come back padded — callers index rows 0..B-1.

    Backends: "xla" — the sequential scan (arena batches: the blocked
    solve where eligible); "blocked" int32 max-plus blocked solve
    (sqrt(V) depth) — exact by integer construction, guarded only
    against int32-range overflow and the f32-parity line (see
    ops/dp_blocked.py); rows whose long-edge iteration fails to converge
    fall back to the scan.

    Batches packed into an arena (native pack_batch) take the
    single-transfer fast path on the xla backend.
    """
    if backend == "xla" and "_arena" in batch:
        Bp, V, W, K = batch["_dims"]
        solver = arena_solver(batch, V)
        # int8 squeeze when depth < 128: halves the upload again.
        a8 = _squeeze_arena8(batch)
        if a8 is not None:
            dev = jnp.asarray(a8)
            packed = _dp_scores_arena8(
                dev, B=Bp, V=V, W=W, K=K, solver=solver
            )
            return _PackedFuture(
                packed,
                lambda: _dp_scores_arena8_full(dev, B=Bp, V=V, W=W, K=K),
            )  # type: ignore[return-value]
        return submit_arena_scores(
            batch["_arena"], Bp, V, W, K, solver=solver
        )
    if backend == "xla" and "_edges_arena" in batch:
        Bp, V, W, K, E, X = batch["_dims"]
        return submit_edges_scores(batch["_edges_arena"], Bp, V, W, K, E, X)
    batch = _pad_b(batch)
    if backend == "blocked":
        from pbdagcon_tpu.ops.dp_blocked import blocked_safe, dp_scores_blocked

        V = batch["win_count"].shape[1]
        max_esc = max(
            float(np.abs(batch["cov"]).max(initial=0)) * 0.5
            + float(batch["win_count"].max(initial=0)),
            10.0,
        )
        if V % _blocked_L(V) == 0 and blocked_safe(max_esc, V):
            args = tuple(jnp.asarray(batch[k]) for k in DP_KEYS)
            s, unconv = dp_scores_blocked(*args, L=_blocked_L(V))
            return _BlockedFuture(s, unconv, args)  # type: ignore[return-value]
        backend = "xla"
    s = dp_scores(*(jnp.asarray(batch[k]) for k in DP_KEYS))
    packed = _compress_scores(s)
    return _CompressedScores(s, packed)  # type: ignore[return-value]


def submit_batch_scores(
    lins: list[LinearGraph],
    V: int,
    W: int,
    K: int = 32,
    backend: str = "xla",
) -> jax.Array:
    """Pack (Python) + dispatch the device DP for a bucket; async."""
    return submit_packed_scores(pad_batch(lins, V, W, K), backend)


def batch_scores(
    lins: list[LinearGraph],
    V: int,
    W: int,
    K: int = 32,
    backend: str = "xla",
) -> np.ndarray:
    """Run the device DP for a bucket of targets; returns [B, V] f32."""
    return np.asarray(submit_batch_scores(lins, V, W, K, backend))[: len(lins)]
