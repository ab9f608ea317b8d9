"""Device backtrack + path emission for the device-built graph.

Completes the all-on-device consensus pipeline: the banded linear graph
from `ops/devbuild_jax.py` feeds the existing reverse max-plus DP
(`ops/dp.py::dp_scores`), then a forward scan walks the best path with
the reference's first-strict-max tie-break implemented via the 32-bit
creation keys (ties between equal scores pick the minimum key; a tie
involving a KEY_UNCERTAIN edge flags the target for host fallback).

The walk emits per-step (base, kept, backbone-position) straight into
fixed-shape output arrays — the only thing fetched over the link — and
the host assembles FASTA fragments exactly like
`ops/linearize.py::consensus_from_path` (SPEC §2.7).

Reference: `AlnGraphBoost::consensus()` DP + backtrack
(src/cpp/AlnGraphBoost.cpp, SURVEY.md §3.4 — reconstructed, mount empty).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pbdagcon_tpu.ops.devbuild import KEY_MASK, KEY_UNCERTAIN
from pbdagcon_tpu.oracle.graph import CnsResult

I32 = jnp.int32
NEG_INF = jnp.float32(np.float32(np.finfo(np.float32).min))
_PENALTY = jnp.float32(-10.0)


def _pick(tot, keys, valid):
    """First-strict-max with key tie-break over axis -1.

    Returns (argmax index, best score, uncertain-tie flag)."""
    tot = jnp.where(valid, tot, NEG_INF)
    best = jnp.max(tot, axis=-1)  # [B]
    is_max = valid & (tot == best[..., None]) & (best[..., None] > NEG_INF)
    n_max = jnp.sum(is_max, axis=-1)
    masked_key = jnp.where(is_max, keys & KEY_MASK, jnp.int32(1 << 30))
    kmin = jnp.min(masked_key, axis=-1)
    sel = is_max & (masked_key == kmin[..., None])
    idx = jnp.argmax(sel, axis=-1)
    unc = (n_max > 1) & jnp.any(
        is_max & ((keys & KEY_UNCERTAIN) != 0), axis=-1
    )
    return idx, best, unc


@functools.partial(jax.jit, static_argnames=("P",))
def backtrack_emit(build, scores, min_weight, P: int):
    """Scan-free walk: per-node best successors are computed vectorized
    (band totals from W static shifted slices of the score vector; no
    sequential dependence), then the path is extracted with log2(P)
    pointer-doubling steps instead of a P-long per-step scan.
    """
    win = build["win"]
    B, V, W = win.shape
    K = build["long_u"].shape[1]
    n = build["n"]
    cov = build["cov"].astype(jnp.float32)
    unsup = build["unsup"]
    weight = build["weight"]

    full = jnp.concatenate(
        [scores, jnp.zeros((B, 1), jnp.float32)], axis=-1
    )  # [B, V+1]; per-target exit is n (score 0) but padding rows of
    # `scores` are NEG_INF, so shifted slices use a sanitized copy.
    sc = jnp.where(
        jnp.arange(V, dtype=I32)[None, :] < n[:, None], scores, NEG_INF
    )
    sc_ext = jnp.concatenate(
        [sc, jnp.full((B, W + 1), NEG_INF, jnp.float32)], axis=-1
    )
    # per-node edge totals, [B, W, V] layout (V on lanes).
    esc_tgt_unsup = jnp.concatenate(
        [unsup, jnp.zeros((B, W + 1), bool)], axis=-1
    )
    esc_tgt_cov = jnp.concatenate(
        [cov, jnp.zeros((B, W + 1), jnp.float32)], axis=-1
    )
    # Shifted target views shifted[b, w, v] = x[b, v + 1 + w] via a
    # single patch-extraction op per array (keeps the HLO small — an
    # unrolled slice loop explodes compile time at W = 96).
    def shifted(x):
        # precision=HIGHEST is parity-critical: an f32 conv may
        # otherwise run in reduced precision (TF32 on the GPU keeps 10
        # mantissa bits), which would round the f32 scores flowing
        # through the identity patch filter (scores are exact multiples
        # of 0.5 into the thousands) and corrupt tie evaluation.
        p = jax.lax.conv_general_dilated_patches(
            x[:, 1:, None].astype(jnp.float32),
            filter_shape=(W,),
            window_strides=(1,),
            padding="VALID",
            dimension_numbers=("NHC", "HIO", "NHC"),
            precision=jax.lax.Precision.HIGHEST,
        )  # [B, V+1, W] -> slice to V rows
        return jnp.swapaxes(p[:, :V, :], 1, 2)  # [B, W, V]

    sh_sc = shifted(sc_ext)
    sh_uns = shifted(esc_tgt_unsup) > 0.5
    sh_cov = shifted(esc_tgt_cov)
    winT = jnp.swapaxes(win, 1, 2)  # [B, W, V]
    wkeyT = jnp.swapaxes(build["wkey"], 1, 2)
    esc_band = jnp.where(
        sh_uns, _PENALTY, winT.astype(jnp.float32) - 0.5 * sh_cov
    )
    tot_band = jnp.where(winT >= 0, esc_band + sh_sc, NEG_INF)

    vidx = jnp.arange(V, dtype=I32)[None, :]
    # exit edge: tgt score = 0, esc = count.
    x_cnt = build["exit_cnt"]
    tot_exit = jnp.where(
        x_cnt >= 0, x_cnt.astype(jnp.float32), NEG_INF
    )
    # long edges: contribute only at their source node.
    l_u = build["long_u"]
    l_w = build["long_w"]
    l_tot = build["long_esc"] + jnp.take_along_axis(
        jnp.concatenate([sc, jnp.zeros((B, 1), jnp.float32)], axis=-1),
        jnp.clip(jnp.where(l_w == n[:, None], V, l_w), 0, V),
        axis=-1,
    )
    l_tot = jnp.where(l_u >= 0, l_tot, NEG_INF)  # [B, K]
    tot_long = jnp.where(
        l_u[:, :, None] == vidx[:, None, :], l_tot[:, :, None], NEG_INF
    )  # [B, K, V]

    # vectorized argpick over the (W + 1 + K) candidate axis:
    # lexicographic (max tot, min masked key) + uncertain-tie flag.
    cand_tot = jnp.concatenate(
        [tot_band, tot_exit[:, None, :], tot_long], axis=1
    )
    cand_key = jnp.concatenate(
        [
            wkeyT,
            build["exit_key"][:, None, :],
            jnp.broadcast_to(build["long_key"][:, :, None], (B, K, V)),
        ],
        axis=1,
    )
    best = jnp.max(cand_tot, axis=1)  # [B, V]
    is_max = (cand_tot == best[:, None, :]) & (best[:, None, :] > NEG_INF)
    kmask = jnp.where(is_max, cand_key & KEY_MASK, jnp.int32(1 << 30))
    kmin = jnp.min(kmask, axis=1)
    n_max = jnp.sum(is_max, axis=1)
    node_unc = (n_max > 1) & jnp.any(
        is_max & ((cand_key & KEY_UNCERTAIN) != 0), axis=1
    )
    sel = is_max & (kmask == kmin[:, None, :])
    j = jnp.argmax(sel, axis=1)  # [B, V] winning candidate index
    is_band = j < W
    is_exit = j == W
    lw_sel = jnp.take_along_axis(
        l_w, jnp.clip(j - W - 1, 0, K - 1), axis=-1
    )
    best_next = jnp.where(
        is_band,
        vidx + 1 + j,
        jnp.where(
            is_exit,
            n[:, None],
            jnp.where(lw_sel == n[:, None], n[:, None], lw_sel),
        ),
    )
    nxt = jnp.where(best > NEG_INF, best_next, n[:, None])

    # ---- enter pick ---------------------------------------------------
    ent = build["enter"]
    full_sc = jnp.concatenate([sc, jnp.zeros((B, 1), jnp.float32)], -1)
    e_tgt = ent["tgt"]
    e_is_exit = e_tgt == n[:, None]
    e_sc = jnp.where(
        e_is_exit, 0.0,
        jnp.take_along_axis(full_sc, jnp.clip(e_tgt, 0, V), axis=-1),
    )
    tc = jnp.clip(e_tgt, 0, V - 1)
    e_unsup = jnp.take_along_axis(unsup, tc, axis=-1)
    e_cov = jnp.take_along_axis(cov, tc, axis=-1)
    e_esc = jnp.where(
        e_unsup, _PENALTY,
        ent["cnt"].astype(jnp.float32) - 0.5 * e_cov,
    )
    e_esc = jnp.where(e_is_exit, ent["cnt"].astype(jnp.float32), e_esc)
    e_tot = jnp.where(ent["present"], e_esc + e_sc, NEG_INF)
    e_idx, _e_best, e_unc0 = _pick(e_tot, ent["key"], ent["present"])
    u0 = jnp.take_along_axis(e_tgt, e_idx[:, None], axis=-1)[:, 0]
    u0 = jnp.where(jnp.any(ent["present"], axis=-1), u0, n)

    # ---- pointer-jumping path extraction ------------------------------
    # jump tables: J0 = nxt; J_{k+1}[v] = J_k[J_k[v]] (exit absorbs).
    nxt_ext = jnp.concatenate([nxt, n[:, None]], axis=-1)  # idx V = exit
    unc_ext = jnp.concatenate(
        [node_unc, jnp.zeros((B, 1), bool)], axis=-1
    )

    def ext_gather(tbl, idx):
        """Exit-absorbing gather: indices at or past n read the exit."""
        ic = jnp.clip(jnp.where(idx >= n[:, None], V, idx), 0, V)
        return jnp.take_along_axis(tbl, ic, axis=-1)

    # Two-level walk: doubling tables only up to 2^(LVL-1) steps (each
    # level is a V-wide elementwise gather), then a sequential chain of
    # [B]-sized jumps for the P/2^LVL block starts (tiny-op latency
    # only), then an in-block fill with the LVL tables. Halves the
    # V-wide gather count vs full pointer doubling (exact same path
    # semantics).
    nbits = max(1, (P - 1).bit_length())
    LVL = min(nbits, 6)
    jumps = [nxt_ext]
    for _ in range(LVL - 1):
        j = jumps[-1]
        jumps.append(
            jnp.concatenate(
                [ext_gather(j, j[:, :V]), n[:, None]], axis=-1
            )[:, : V + 1]
        )
    BLK = 1 << LVL
    NB = -(-P // BLK)
    half = jumps[-1]  # 2^(LVL-1)-step table
    starts = [u0]
    curs = u0
    for _ in range(NB - 1):
        curs = ext_gather(half, ext_gather(half, curs[:, None]))[:, 0]
        starts.append(curs)
    sgrid = jnp.stack(starts, axis=1)  # [B, NB] block starts
    cur = jnp.repeat(sgrid, BLK, axis=1)[:, :P]
    ridx = (jnp.arange(P, dtype=I32) % BLK)[None, :]
    for k in range(LVL):
        stepped = ext_gather(jumps[k], cur)
        cur = jnp.where((ridx >> k) & 1 == 1, stepped, cur)
    path = cur  # [B, P] node at step i (exit-absorbed)
    valid = path < n[:, None]
    path_len = jnp.sum(valid, axis=-1, dtype=I32)
    # ambiguity: any uncertain tie along the realized path (including
    # the enter pick).
    amb = e_unc0 | jnp.any(
        ext_gather(unc_ext, path) & valid, axis=-1
    )
    # overflow: P steps didn't reach exit.
    last = path[:, -1]
    last_next = ext_gather(nxt_ext, last[:, None])[:, 0]
    overflow = (last < n) & (last_next < n)

    # ---- emission gathers ---------------------------------------------
    pclip = jnp.clip(path, 0, V - 1)
    bases = jnp.where(
        valid,
        jnp.take_along_axis(build["base"].astype(jnp.int32), pclip, -1),
        0,
    ).astype(jnp.uint8)
    kept = valid & (
        jnp.take_along_axis(weight, pclip, axis=-1) >= min_weight
    )
    bpos = jnp.where(
        valid, jnp.take_along_axis(build["bbpos"], pclip, axis=-1), 0
    )
    return {
        "bases": bases,
        "kept": kept,
        "bbpos": bpos.astype(jnp.int32),
        "path_len": path_len,
        "ambiguous": amb,
        "overflow": overflow,
    }


@functools.partial(jax.jit, static_argnames=("P",))
def backtrack_emit_scan(build, scores, min_weight, P: int):
    """Walk the best path on device; emit per-step node attributes.

    build: the `device_build` output dict; scores: [B, V] f32 from
    `dp_scores`. Returns dict with bases/kept/bbpos [B, P], path_len,
    ambiguous + overflow flags.
    """
    win = build["win"]
    wkey = build["wkey"]
    B, V, W = win.shape
    n = build["n"]  # [B]
    cov = build["cov"].astype(jnp.float32)
    unsup = build["unsup"]
    weight = build["weight"]
    base = build["base"]
    bbpos = build["bbpos"]
    exit_cnt = build["exit_cnt"]
    exit_key = build["exit_key"]

    full = jnp.concatenate(
        [scores, jnp.zeros((B, 1), jnp.float32)], axis=-1
    )  # virtual exit at index V (per-target exit is n, remapped below)

    def esc_of(tgt, cnt):
        """Edge score into target node indices [B, X] (tgt == n -> exit:
        esc = count)."""
        is_exit = tgt == n[:, None]
        tc = jnp.clip(tgt, 0, V - 1)
        e_unsup = jnp.take_along_axis(unsup, tc, axis=-1)
        e_cov = jnp.take_along_axis(cov, tc, axis=-1)
        esc = jnp.where(
            e_unsup, _PENALTY, cnt.astype(jnp.float32) - 0.5 * e_cov
        )
        return jnp.where(is_exit, cnt.astype(jnp.float32), esc)

    def score_of(tgt):
        is_exit = tgt == n[:, None]
        sc = jnp.take_along_axis(
            full[:, :V], jnp.clip(tgt, 0, V - 1), axis=-1
        )
        return jnp.where(is_exit, 0.0, sc)

    # ---- enter pick ---------------------------------------------------
    ent = build["enter"]
    e_tot = esc_of(ent["tgt"], ent["cnt"]) + score_of(ent["tgt"])
    e_idx, _e_best, e_unc = _pick(e_tot, ent["key"], ent["present"])
    u0 = jnp.take_along_axis(ent["tgt"], e_idx[:, None], axis=-1)[:, 0]
    u0 = jnp.where(
        jnp.any(ent["present"], axis=-1), u0, n
    )  # no candidates: empty path

    # ---- walk ---------------------------------------------------------
    wlane = jnp.arange(W, dtype=I32)[None, :]
    long_u = build["long_u"]
    long_w = build["long_w"]
    long_key = build["long_key"]
    long_esc = build["long_esc"]

    def step(carry, _):
        u, amb = carry
        at_end = u >= n  # virtual exit (or finished)
        uc = jnp.clip(u, 0, V - 1)[:, None]
        row_cnt = jnp.take_along_axis(win, uc[..., None], axis=1)[:, 0]
        row_key = jnp.take_along_axis(wkey, uc[..., None], axis=1)[:, 0]
        tgt = uc + 1 + wlane  # [B, W]
        x_cnt = jnp.take_along_axis(exit_cnt, uc, axis=-1)
        x_key = jnp.take_along_axis(exit_key, uc, axis=-1)
        cand_tgt = jnp.concatenate([tgt, n[:, None]], axis=-1)
        cand_cnt = jnp.concatenate([row_cnt, x_cnt], axis=-1)
        cand_key = jnp.concatenate([row_key, x_key], axis=-1)
        valid = cand_cnt >= 0
        tot = esc_of(cand_tgt, cand_cnt) + score_of(cand_tgt)
        # K long-edge candidates leaving u (esc precomputed).
        lmask = (long_u == u[:, None]) & (long_u >= 0)
        ltot = jnp.where(
            lmask, long_esc + score_of(long_w), NEG_INF
        )
        cand_tgt = jnp.concatenate([cand_tgt, long_w], axis=-1)
        tot = jnp.concatenate([tot, ltot], axis=-1)
        cand_key = jnp.concatenate([cand_key, long_key], axis=-1)
        valid = jnp.concatenate([valid, lmask], axis=-1)
        idx, _best, unc = _pick(tot, cand_key, valid)
        nxt = jnp.take_along_axis(cand_tgt, idx[:, None], axis=-1)[:, 0]
        nxt = jnp.where(jnp.any(valid, axis=-1), nxt, n)
        out = (
            jnp.where(at_end, jnp.uint8(0), jnp.take_along_axis(
                base, uc, axis=-1)[:, 0]),
            jnp.where(
                at_end,
                False,
                jnp.take_along_axis(weight, uc, axis=-1)[:, 0]
                >= min_weight,
            ),
            jnp.where(at_end, 0, jnp.take_along_axis(
                bbpos, uc, axis=-1)[:, 0]),
            ~at_end,
        )
        amb = amb | (unc & ~at_end)
        u2 = jnp.where(at_end, u, nxt)
        return (u2, amb), out

    (u_fin, amb), (bases, kept, bpos, valid) = jax.lax.scan(
        step, (u0, e_unc), None, length=P
    )
    # scan stacks outputs on axis 0: [P, B] -> [B, P]
    bases = jnp.swapaxes(bases, 0, 1)
    kept = jnp.swapaxes(kept, 0, 1)
    bpos = jnp.swapaxes(bpos, 0, 1)
    valid = jnp.swapaxes(valid, 0, 1)
    path_len = jnp.sum(valid, axis=-1, dtype=I32)
    overflow = u_fin < n  # didn't reach exit within P steps
    return {
        "bases": bases,
        "kept": kept,
        "bbpos": bpos.astype(jnp.int32),
        "path_len": path_len,
        "ambiguous": amb,
        "overflow": overflow,
    }


def assemble_fragments(
    bases: np.ndarray,
    kept: np.ndarray,
    bbpos: np.ndarray,
    path_len: int,
    min_length: int,
) -> list[CnsResult]:
    """Host-side fragment assembly from one target's emitted path
    (consensus_from_path semantics, SPEC §2.7)."""
    results: list[CnsResult] = []
    bb_pos = 0
    kept_end = 0
    range_start = 0
    frag = bytearray()

    def close() -> None:
        nonlocal frag
        if len(frag) >= min_length and len(frag) > 0:
            results.append(
                CnsResult((range_start, kept_end), frag.decode())
            )
        frag = bytearray()

    for i in range(path_len):
        is_bb = bbpos[i] != 0
        if is_bb:
            bb_pos = int(bbpos[i])
        if kept[i]:
            if not frag:
                range_start = bb_pos - 1 if is_bb else bb_pos
            frag.append(int(bases[i]))
            kept_end = bb_pos
        else:
            close()
    close()
    return results
