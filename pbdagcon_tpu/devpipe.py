"""The all-on-device consensus pipeline (backend="devbuild").

Host work shrinks to parse + normalize + encode (the parity-critical
text processing); everything the reference's consensus worker does —
graph build, merge, linearize, best-path DP, backtrack — runs on the
accelerator (`ops/devbuild_jax.py` + `ops/devemit.py`). Targets the
fixed-shape build flags (capacity overflows, absorption cascades,
ambiguous-key ties) fall back to the exact host path, so output stays
bit-identical to the reference architecture regardless.

Upload per target is the encoded read set (~5x smaller than the banded
graph arrays of the host-build path); fetch is the emitted best path.

Reference: the consensus worker pipeline (`src/cpp/main.cpp`,
SURVEY.md §3.1 — reconstructed; mount empty).
"""

from __future__ import annotations

import collections as _collections
import dataclasses
import functools
import logging
import os
from typing import Iterable, Iterator

import numpy as np

from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import TargetGroup
from pbdagcon_tpu.oracle.graph import CnsResult
from pbdagcon_tpu.ops.devbuild import EncodedGroup, encode_group

log = logging.getLogger("pbdagcon_tpu")

# Shape ladders: one compiled program per (B, R, C, L) combination used.
# Rung spacing is a measured trade: the chain-space passes scale with
# NC = R_rung * CH_rung, and coarse rungs waste real device time — a
# 30-read pileup on the 48 rung ran the whole build 24% slower than on
# a 32 rung (45.6k -> 56.6k b/s end to end), and a CH 192 rung bought
# another 11% (-> 63k). Finer rungs cost compile shapes; the persistent
# compilation cache (config.enable_compile_cache) amortizes them.
_B_LADDER = (8, 32, 64, 128)
# Finer primary rungs (r3): the bench pileup (1000bp x 30x) needs
# C=1240/R=30 and paid the 1536/32 rungs' 24% column padding in every
# R*C-wide sort; mixed streams (soak classes 300-6000bp, 8-60x) paid up
# to 4x on C and 2x on R. Need-snapping keeps one compiled shape per
# rung actually hit; the persistent compile cache amortizes new rungs.
_R_LADDER = (16, 32, 48, 64, 96, 128, 256, 512)
_C_LADDER = (256, 512, 768, 1280, 1536, 2048, 4096, 8192, 16384)
_L_LADDER = (256, 512, 1024, 2048, 4096, 8192, 16384)

# 2-bit-pack the ops upload (4 column ops per byte): the ops stream is
# the dominant upload (B*R*C bytes vs ~B*L for everything else). The
# device unpacks with two vector ops fused into the build program.
# Kill switch for A/B measurement only.
_PACK_OPS = os.environ.get("DAGCON_PACK_OPS", "1") == "1"


def _ladder(x: int, ladder: tuple[int, ...]) -> int | None:
    for v in ladder:
        if x <= v:
            return v
    return None


@dataclasses.dataclass(frozen=True)
class DevCapsConfig:
    """Derived caps for secondary dimensions, scaled from (R, C, L).

    Two profiles: `compact()` sizes for PacBio-like insertion density
    (~9%/position) and `heavy()` for gap-heavy pileups (~25%). The
    pipeline picks per batch from the measured insertion fraction;
    an under-sized pick only raises the flag/fallback rate — output is
    exact either way."""

    W: int = 96
    SM: int = 20
    SE: int = 16
    DQ: int = 12
    K: int = 32
    nd_per_l: int = 8

    @staticmethod
    def compact() -> "DevCapsConfig":
        return DevCapsConfig(W=64, SM=12, SE=10, nd_per_l=4)

    @staticmethod
    def heavy() -> "DevCapsConfig":
        return DevCapsConfig()


def ins_cap(caps) -> int:
    """Fixed ins-base stream width for a caps combination. Tied to the
    trie-node cap: a target's trie can never need more nodes than it
    has inserted bases, so NI <= ND keeps both caps consistent and the
    host-side NI pre-filter implies the device node cap holds."""
    return max(256, caps.ND)


# Secondary-dimension ladders: measured per-batch requirements snap up
# to a rung so one workload compiles O(1) shapes while the hot arrays
# (which scale with SM * ND and R * CH) stay ~2x tighter than the old
# worst-case formulas. Undersized picks only flag targets to the exact
# host path — output is bit-identical either way.
_SM_LADDER = (8, 10, 12, 14, 20)  # fine rungs: a few sm_need=9..10
# outlier targets otherwise drag a whole window to 14, fattening every
# SM-scaled array ~40% and pushing NC*SM past the 16-bit packing gates.
_W_LADDER = (32, 48, 64, 96, 128)  # band width: adapted per bucket from
# the build's measured `wneed` (the band is the largest array family;
# the heavy profile's fixed 96 measured 6% slower than the 48 the bench
# workload actually needs). Undersized W only flags to the host path.
_CH_LADDER = (32, 64, 128, 192, 256, 512)
_ND_LADDER = (768, 1536, 3072, 4608, 6144, 8448, 12288, (1 << 14) - 1)
_DQ_LADDER = (4, 6, 8, 12)
_SE_LADDER = (4, 8, 12, 14, 16)  # fine top rungs: the SE slot loop and
# its [B, SE, V] transport scale linearly with the rung, and bench-like
# pileups measure se_need 13 — a 14 rung shaves 12% off that block.


def caps_for(
    B: int, R: int, C: int, L: int, cfg: DevCapsConfig,
    *,
    ch_need: int | None = None,
    sm_need: int | None = None,
    nd_need: int | None = None,
    dq_need: int | None = None,
    se_need: int | None = None,
    w_need: int | None = None,
    v_need: int | None = None,
):
    """Build-shape caps from the primary bucket dims.

    `*_need` are measured per-batch maxima (from the encoder metas:
    max insertion chains per read, max chain length, max per-target
    inserted bases, max interior transition span, max chain starts per
    anchor); when given, the matching cap snaps to the smallest ladder
    rung that covers the batch instead of the worst-case formula. An
    undersized cap only flags targets to the exact host path.
    """
    from pbdagcon_tpu.ops.devbuild_jax import Caps

    # The flat chain table R*CH must fit the 14-bit packed chain index
    # (hard limit); C//8 is only the sizing heuristic when no measured
    # need is available (~C/13 chains/read at PacBio-like noise).
    # Overflow (more chains than CH) flags the target to the host path.
    ch_hard = max(32, min(512, (1 << 14) // R))
    CH = max(32, min(C // 8, ch_hard))
    if ch_need is not None:
        CH = min(ch_hard, _ladder(max(1, ch_need), _CH_LADDER) or ch_hard)
    SM = cfg.SM
    if sm_need is not None:
        SM = _ladder(max(1, sm_need), _SM_LADDER) or _SM_LADDER[-1]
    ND = min(cfg.nd_per_l * L + 256, (1 << 14) - 1)  # gpre key limit
    if nd_need is not None:
        ND = min(
            _ladder(max(1, nd_need), _ND_LADDER) or (1 << 14) - 1,
            (1 << 14) - 1,
        )
    DQ = cfg.DQ
    if dq_need is not None:
        DQ = _ladder(max(1, dq_need), _DQ_LADDER) or _DQ_LADDER[-1]
    SE = cfg.SE
    if se_need is not None:
        SE = _ladder(max(1, se_need), _SE_LADDER) or _SE_LADDER[-1]
    W = cfg.W
    if w_need is not None:
        W = _ladder(max(1, w_need), _W_LADDER) or _W_LADDER[-1]
    # Linear-graph length: L + ND is the safe bound (every inserted
    # base could become a node), but the post-merge node count the
    # build measures is typically ~25% smaller; when the pipeline has
    # an observed `v_need` it shrinks V (multiple of 256 — the blocked
    # DP requires V % 64 == 0). Undersized V only flags (over_v).
    # V is ALWAYS 256-aligned (tests/test_devpipe.py::
    # test_caps_v_alignment_fence), which also satisfies the blocked
    # DP's V % 64 == 0 requirement everywhere instead of only on the
    # v_need path.
    V = -(-(L + ND) // 256) * 256
    if v_need is not None:
        V = min(V, max(512, -(-v_need // 256) * 256))
    return Caps(
        B=B, R=R, C=C, L=L,
        CH=CH,
        SM=SM,
        NC=R * CH,
        ND=ND,
        SE=SE,
        DQ=DQ,
        V=V,
        W=W,
        K=cfg.K,
    )


def chain_stats(
    ops: np.ndarray, starts: np.ndarray
) -> tuple[int, int, int, int]:
    """(max chains per read, max chain length, max interior transition
    span, max chain starts per anchor) for an encoded ops array [R, C]
    — the Python-path mirror of the native meta[5:9]."""
    from pbdagcon_tpu.ops.devbuild import OP_DEL, OP_INS, OP_MATCH

    R, C = ops.shape
    m = ops == OP_MATCH
    seg = np.cumsum(m, axis=-1) - m
    isin = ops == OP_INS
    consume = m | (ops == OP_DEL)
    tpos = starts[:, None] - 1 + np.cumsum(consume, axis=-1)
    nmat = m.sum(-1)
    # per-read match positions, compacted to the front in column order
    mp = np.sort(np.where(m, tpos, np.int64(1) << 40), axis=-1)
    # interior transition spans: gaps between consecutive matches whose
    # inter-match segment (id j+1) holds no insertion.
    seg_ins = np.zeros((R, C + 2), dtype=bool)
    rr, cc = np.nonzero(isin)
    seg_ins[rr, seg[rr, cc]] = True
    max_dq = 0
    if C > 1:
        gaps = mp[:, 1:] - mp[:, :-1]
        ok = (
            (np.arange(1, C)[None, :] < nmat[:, None])
            & ~seg_ins[:, 1:C]
        )
        if ok.any():
            max_dq = int(gaps[ok].max())
    if not isin.any():
        return 0, 0, max_dq, 0
    key = rr.astype(np.int64) * (C + 1) + seg[rr, cc]
    uniq, first_idx, counts = np.unique(
        key, return_index=True, return_counts=True
    )
    chains_per_read = np.bincount(rr[first_idx], minlength=R)
    # chain start anchors: p = previous match position (0 = enter).
    r_u = (uniq // (C + 1)).astype(np.int64)
    seg_u = (uniq % (C + 1)).astype(np.int64)
    p_u = np.where(seg_u == 0, 0, mp[r_u, np.maximum(seg_u - 1, 0)])
    max_se = int(np.bincount(p_u.astype(np.int64)).max())
    return (
        int(chains_per_read.max()), int(counts.max()), max_dq, max_se
    )


def encode_groups(
    groups: Iterable[TargetGroup], cfg: DagconConfig
) -> Iterator[tuple[TargetGroup, EncodedGroup | None]]:
    """Host-side encode (normalize + column streams) per group. Groups
    that cannot be encoded (raw pairs without -a already skipped by the
    encoder) yield None and fall back."""
    for group in groups:
        alns = group.alns
        if cfg.align:
            from pbdagcon_tpu.aligner import align_record

            alns = [
                align_record(a, cfg.align_scorer, cfg.affine_params)
                for a in alns
            ]
        else:
            alns = [a for a in alns if len(a.qstr) == len(a.tstr)]
        try:
            enc = encode_group(
                group.backbone, alns, trim=cfg.trim, sid=group.sid
            )
        except Exception:
            yield group, None
            continue
        yield group, enc


def _pack_batch(encs: list[EncodedGroup], caps):
    B = caps.B
    ops = np.zeros((B, caps.R, caps.C), dtype=np.uint8)
    starts = np.zeros((B, caps.R), dtype=np.int32)
    bb = np.zeros((B, caps.L), dtype=np.uint8)
    Lr = np.zeros(B, dtype=np.int32)
    # The ins-stream width is a FUNCTION of the caps (one compiled
    # program per caps combination — a data-dependent width would
    # recompile per batch). Overflowing targets fall back.
    ni = ins_cap(caps)
    ins = np.zeros((B, ni), dtype=np.uint8)
    for b, e in enumerate(encs):
        R, C = e.ops.shape
        ops[b, :R, :C] = e.ops
        starts[b, :R] = e.starts
        bb[b, : len(e.backbone)] = e.backbone
        Lr[b] = len(e.backbone)
        ins[b, : len(e.ins_base)] = e.ins_base
    return ops, starts, bb, ins, Lr


def _host_consensus(group: TargetGroup, cfg: DagconConfig) -> list[CnsResult]:
    """Exact host fallback for flagged targets."""
    from pbdagcon_tpu.pipeline import (
        consensus_for_lin,
        linearize_group,
    )
    from pbdagcon_tpu.ops.linearize import host_scores

    lin = linearize_group(group, cfg)
    return consensus_for_lin(lin, host_scores(lin), cfg)


def run_devbuild_pipeline(
    groups: Iterable[TargetGroup],
    cfg: DagconConfig,
    stats,
) -> Iterator[tuple[str, list[CnsResult]]]:
    """Batched device-build consensus over a stream of target groups,
    in input order."""
    import jax.numpy as jnp

    from pbdagcon_tpu.ops import devemit
    from pbdagcon_tpu.ops.devbuild_jax import device_build
    from pbdagcon_tpu.ops.dp import dp_scores

    dcfg = DevCapsConfig()
    pending: list[tuple[TargetGroup, EncodedGroup | None]] = []

    def fits(e: EncodedGroup) -> bool:
        R, C = e.ops.shape
        return (
            _ladder(R, _R_LADDER) is not None
            and _ladder(C, _C_LADDER) is not None
            and _ladder(len(e.backbone), _L_LADDER) is not None
        )

    def flush() -> Iterator[tuple[str, list[CnsResult]]]:
        nonlocal pending
        batchables = [
            (i, e) for i, (g, e) in enumerate(pending) if e is not None
        ]
        results: dict[int, list[CnsResult]] = {}
        if batchables:
            Rb = _ladder(
                max(e.ops.shape[0] for _, e in batchables), _R_LADDER
            )
            Cb = _ladder(
                max(e.ops.shape[1] for _, e in batchables), _C_LADDER
            )
            Lb = _ladder(
                max(len(e.backbone) for _, e in batchables), _L_LADDER
            )
            Bb = _ladder(len(batchables), _B_LADDER) or _B_LADDER[-1]
            tot_ins = sum(len(e.ins_base) for _, e in batchables)
            tot_cols = sum(int(e.ncols.sum()) for _, e in batchables)
            prof = (
                DevCapsConfig.compact()
                if tot_ins <= 0.11 * max(1, tot_cols)
                else DevCapsConfig.heavy()
            )
            ch_n = sm_n = nd_n = dq_n = se_n = 0
            for _, e in batchables:
                c_, s_, d_, a_ = chain_stats(e.ops, e.starts)
                ch_n = max(ch_n, c_)
                sm_n = max(sm_n, s_)
                nd_n = max(nd_n, len(e.ins_base))
                dq_n = max(dq_n, d_)
                se_n = max(se_n, a_)
            # Sticky needs across flushes (same rationale as the native
            # path's _NEED_RECENT: per-flush maxima flip rungs and every
            # distinct caps is a fresh compile).
            import collections as _collections

            nrec = _NEED_RECENT.setdefault(
                (Rb, Cb, Lb, prof.W), _collections.deque(maxlen=8)
            )
            nrec.append((ch_n, sm_n, nd_n, dq_n, se_n))
            ch_n, sm_n, nd_n, dq_n, se_n = (
                max(t[k] for t in nrec) for k in range(5)
            )
            caps = caps_for(
                Bb, Rb, Cb, Lb, prof,
                ch_need=ch_n, sm_need=sm_n, nd_need=nd_n,
                dq_need=dq_n, se_need=se_n,
            )
            # ins-stream width is fixed per caps; oversized targets
            # take the host path instead of truncating.
            batchables = [
                (i, e) for i, e in batchables
                if len(e.ins_base) <= ins_cap(caps)
            ]
            for lo in range(0, len(batchables), caps.B):
                part = batchables[lo : lo + caps.B]
                encs = [e for _, e in part]
                while len(encs) < caps.B:
                    encs.append(encs[0])
                ops, starts, bbuf, ins, Lrr = _pack_batch(encs, caps)
                build = device_build(
                    jnp.asarray(ops), jnp.asarray(starts),
                    jnp.asarray(bbuf), jnp.asarray(ins),
                    jnp.asarray(Lrr), caps,
                )
                scores = dp_scores(*(build[k] for k in BUILD_DP_KEYS))
                P = min(caps.V, 2 * caps.L + 64)
                emit = devemit.backtrack_emit(
                    build, scores, jnp.int32(cfg.min_weight), P
                )
                flags = np.asarray(build["flags"])
                amb = np.asarray(emit["ambiguous"])
                ovf = np.asarray(emit["overflow"])
                bases = np.asarray(emit["bases"])
                kept = np.asarray(emit["kept"])
                bbpos = np.asarray(emit["bbpos"])
                plen = np.asarray(emit["path_len"])
                stats.batches += 1
                for j, (pi, e) in enumerate(part):
                    if flags[j] or amb[j] or ovf[j]:
                        stats.host_fallbacks += 1
                        results[pi] = _host_consensus(
                            pending[pi][0], cfg
                        )
                    else:
                        results[pi] = devemit.assemble_fragments(
                            bases[j], kept[j], bbpos[j], int(plen[j]),
                            cfg.min_length,
                        )
                    stats.real_nodes += int(e.ops.shape[0])
        for pi, (group, e) in enumerate(pending):
            if pi in results:
                res = results[pi]
            else:
                stats.host_fallbacks += 1
                res = _host_consensus(group, cfg)
            stats.fragments += len(res)
            stats.consensus_bases += sum(len(r.seq) for r in res)
            yield group.sid, res
        pending = []

    for group, enc in encode_groups(groups, cfg):
        stats.targets += 1
        if enc is not None and not fits(enc):
            enc = None  # over every ladder: host fallback
        pending.append((group, enc))
        if len(pending) >= cfg.batch_targets:
            yield from flush()
    yield from flush()


# jitted full-step programs keyed by (caps, P): shared across windows,
# streams, and run_devbuild_native calls in one process (the persistent
# compile cache only saves the XLA backend compile — the jaxpr trace +
# lowering is per jit-wrapper and costs ~0.5s at these shapes).
_STEP_CACHE: dict = {}

# Adaptive band-width / graph-length state, also process-wide: the
# hybrid scheduler calls run_devbuild_native once per ~3 MB chunk, and
# per-call state would forget the learned rungs between chunks. Keyed
# by bucket (Rb, Cb, Lb, profile W), which characterizes the workload
# class.
_W_STATE: dict = {}
_W_RECENT: dict = {}
_V_STATE: dict = {}
# Sticky secondary needs (ch/sm/nd/dq/se) per bucket: window-local
# maxima flip rungs batch to batch (e.g. se_need 13 then 15 picks the
# 14 then the 16 rung), and every distinct caps is a fresh compiled
# program. Aggregating needs over the
# recent-window deque (same pattern as the W/V adaptation) keeps one
# caps per workload class while still tracking real shifts.
_NEED_RECENT: dict = {}


def choose_window_caps(bkey, sub, prof, w_state, v_state, need_recent):
    """Pure caps choice for one window's bucket: sticky secondary needs
    aggregate over the bucket's recent-window deque so one workload
    class converges to ONE compiled caps (the round-3 flip-flop bug
    class). Extracted from submit_window so the convergence property is
    unit-testable (tests/test_devpipe.py::test_caps_convergence_*)."""
    Rb, Cb, Lb, _w = bkey
    nrec = need_recent.setdefault(bkey, _collections.deque(maxlen=8))
    nrec.append(tuple(int(sub[:, c].max()) for c in (5, 6, 3, 7, 8)))
    ch_n, sm_n, nd_n, dq_n, se_n = (
        max(t[k] for t in nrec) for k in range(5)
    )
    # Depth-bucketed batching: deep/wide piles (large R*C) take a
    # smaller B rung so the dominant [B, R, C]-scaled passes stay
    # within a bounded footprint — fewer targets x deeper piles per
    # dispatch instead of a half-padded 128 batch (the 100-500x regime,
    # BASELINE config #3).
    b_fit = _ladder(len(sub), _B_LADDER) or _B_LADDER[-1]
    while b_fit > _B_LADDER[0] and b_fit * Rb * Cb > (1 << 26):
        b_fit = _B_LADDER[_B_LADDER.index(b_fit) - 1]
    return caps_for(
        b_fit,
        Rb, Cb, Lb, prof,
        ch_need=ch_n,
        sm_need=sm_n,
        nd_need=nd_n,
        dq_need=dq_n,
        se_need=se_n,
        w_need=w_state.get(bkey, 48 if Rb <= 48 else prof.W),
        v_need=v_state.get(bkey),
    )


# Build outputs that feed the DP, in `dp.dp_scores` argument order.
BUILD_DP_KEYS = (
    "win", "exit_cnt", "cov", "unsup", "long_u", "long_w", "long_esc",
)


def dp_route(caps) -> str:
    """DP solver for one devbuild step: "blocked" (int32 max-plus
    blocked solve) where its half-unit range bound holds (edge counts and
    coverage are bounded by the read cap, so 1.5 * R + 10 bounds every
    |escore|) and the band is narrow (~W^2 work per node against the
    scan's W), else "scan" (`dp.dp_scores`). Both are exact; rows whose
    long-edge Kleene iteration fails to converge in the blocked solve
    are flagged to the exact host path like any other build flag."""
    from pbdagcon_tpu.ops.dp_blocked import blocked_safe

    if (
        caps.W <= 32
        and caps.V % 64 == 0
        and blocked_safe(1.5 * caps.R + 10.0, caps.V)
    ):
        return "blocked"
    return "scan"


def step_programs(caps, P):
    """(build, dp_emit) jitted programs of one devbuild step, memoized
    per (caps, P) in `_STEP_CACHE`: a fresh jit closure per submit
    window would re-trace and re-lower the whole program each window.

    Two dispatches per batch, not one fused program: fusing holds every
    build intermediate plus the [B, V, W] bands live in one program;
    separate programs free each stage's intermediates at its boundary.
    The DP and the backtrack fuse (the emit consumes the build outputs
    anyway and the DP carries are tiny)."""
    import jax
    import jax.numpy as jnp

    from pbdagcon_tpu.ops import devemit
    from pbdagcon_tpu.ops.devbuild_jax import (
        device_build,
        device_build_packed,
    )
    from pbdagcon_tpu.ops.dp import dp_scores
    from pbdagcon_tpu.ops.dp_blocked import dp_scores_blocked

    key = (caps, P)
    cached = _STEP_CACHE.get(key)
    if cached is not None:
        return cached
    route = dp_route(caps)
    # static guard for the i16 bbpos wire cast below: positions are
    # bounded by the 15-bit packed pic field in devbuild_jax's assemble
    # (assert 3*R < 2^14 and L+1 < 2^15 there); widening the L ladder
    # past 0x7FFF would silently wrap the cast.
    assert caps.L <= 0x7FFF, "i16 bbpos wire format requires L <= 32767"

    @jax.jit
    def dp_emit(build, mw):
        flags = build["flags"]
        dp_args = tuple(build[k] for k in BUILD_DP_KEYS)
        if route == "blocked":
            scores, unconv = dp_scores_blocked(*dp_args)
            flags = flags | unconv
        else:
            scores = dp_scores(*dp_args)
        emit = devemit.backtrack_emit(build, scores, mw, P)
        # Fetch-side wire format: bases are ASCII (< 128), so the kept
        # bit rides the top bit of the base byte; backbone positions are
        # <= L_LADDER max 16384, so i16 halves the largest fetched
        # tensor. Unpacked in emit_window.
        return {
            "flags": flags,
            "ambiguous": emit["ambiguous"],
            "overflow": emit["overflow"],
            # mask to 7 bits so a non-ASCII byte that slipped through
            # encoding can never flip the kept bit.
            "bk": (emit["bases"] & jnp.uint8(0x7F))
            | (emit["kept"].astype(jnp.uint8) << 7),
            "bbpos": emit["bbpos"].astype(jnp.int16),
            "path_len": emit["path_len"],
            # band-adaptation feedback (tiny [B] vectors): the hard span
            # requirement and the K-file pressure this batch.
            "wneed": build["wneed"],
            "nlong": build["nlong"],
            "nv": build["n"],
        }

    build = functools.partial(
        device_build_packed if _PACK_OPS else device_build, caps=caps
    )
    _STEP_CACHE[key] = (build, dp_emit)
    return build, dp_emit


def full_step(caps, P):
    """One devbuild step: encoded batch in, packed emit dict out."""
    build, dp_emit = step_programs(caps, P)

    def step(ops, starts, bbuf, ins, Lr, mw):
        return dp_emit(build(ops, starts, bbuf, ins, Lr), mw)

    return step


def run_devbuild_native(
    stream,
    out,
    cfg: DagconConfig,
    stats,
    journal=None,
    chunk_bytes: int = 16 << 20,
):
    """Native streaming devbuild: C++ parse/normalize/encode (threaded),
    device build + DP + backtrack, host fragment assembly; flagged
    targets use the engine's exact consensus. FASTA in input order."""
    import os as _os

    import jax.numpy as jnp

    from pbdagcon_tpu import native
    from pbdagcon_tpu.io import format_fasta
    from pbdagcon_tpu.ops import devemit

    chunk_bytes = int(
        _os.environ.get("DAGCON_CHUNK_MB", str(cfg.chunk_mb))
    ) << 20
    eng = native.NativeEngine(
        min_weight=cfg.min_weight, min_length=cfg.min_length,
        trim=cfg.trim, threads=cfg.threads, align=cfg.align,
        scorer=cfg.align_scorer, affine_params=cfg.affine_params,
    )
    # Adaptive band width per bucket (see _W_STATE): batches start at a
    # tight W rung (48 for shallow pileups, the profile W for deep
    # ones) and FUTURE batches resize from the measured hard span
    # (`wneed`) and K-file pressure (`nlong`) of recent ones. Undersized
    # W only flags targets to the exact host path, so any adaptation
    # mistake costs speed, never parity. Emit thread writes, submit
    # thread reads; plain dict assignment is atomic under the GIL.
    import collections as _collections

    w_state = _W_STATE
    w_recent = _W_RECENT
    v_state = _V_STATE

    def w_adapt(
        bkey: tuple, caps, wneed_max: int, nlong_max: int, n_max: int
    ) -> None:
        rec = w_recent.setdefault(bkey, _collections.deque(maxlen=8))
        rec.append((wneed_max, nlong_max, n_max))
        need = max(w for w, _, _ in rec)
        rung = _ladder(max(need, 32), _W_LADDER) or _W_LADDER[-1]
        if max(nl for _, nl, _ in rec) > caps.K * 3 // 4:
            nxt = [w for w in _W_LADDER if w > rung]
            rung = nxt[0] if nxt else rung
        # V shrinks toward the measured node count (+12% headroom for
        # batch-to-batch variation); `n` is exact even on flagged
        # targets, so an undersized pick self-corrects next batch.
        w_state[bkey] = rung
        v_state[bkey] = int(1.12 * max(n for _, _, n in rec)) + 1

    def chunks():
        if hasattr(stream, "read"):
            while True:
                buf = stream.read(chunk_bytes)
                if not buf:
                    break
                yield buf.encode() if isinstance(buf, str) else buf, False
        else:
            acc, size = [], 0
            for line in stream:
                b = line.encode() if isinstance(line, str) else line
                acc.append(b)
                size += len(b)
                if size >= chunk_bytes:
                    yield b"".join(acc), False
                    acc, size = [], 0
            if acc:
                yield b"".join(acc), False
        yield b"", True

    # Three-stage pipeline, one stage per thread (same shape as
    # _run_stream_native): a producer encodes small text slices (the
    # C++ engine releases the GIL), the main thread windows targets and
    # dispatches the device programs, an emitter fetches + assembles +
    # writes. Engine enc indices shift on enc_clear, so submits (which
    # read metas/fill at offsets) and the emit+clear section serialize
    # on idx_lock; at submit time exactly the unemitted windows'
    # targets are retained, keeping offsets aligned.
    import queue as _queue
    import threading
    import time as _time

    # Env-gated phase profile (DAGCON_DEVPIPE_PROF=1): wall-busy seconds
    # per pipeline phase, printed to stderr at stream end. Threads run
    # concurrently, so phases can sum past the wall time; the signal is
    # which phase tracks the end-to-end wall.
    prof_on = _os.environ.get("DAGCON_DEVPIPE_PROF", "0") == "1"
    phases = {
        "encode": 0.0, "fill": 0.0, "upload": 0.0, "dispatch": 0.0,
        "fetch": 0.0, "assemble": 0.0, "write": 0.0, "emit_wait": 0.0,
    }

    slice_bytes = min(chunk_bytes, 4 << 20)
    WIN = max(32, cfg.batch_targets)
    q: "_queue.Queue[object]" = _queue.Queue()
    SENTINEL = object()
    producer_err: list[BaseException] = []
    stop = threading.Event()
    cond = threading.Condition()
    retained = [0]
    limit = 3 * WIN

    def producer() -> None:
        try:
            for data, flush_f in chunks():
                if len(data) > slice_bytes:
                    views = [
                        data[o : o + slice_bytes]
                        for o in range(0, len(data), slice_bytes)
                    ]
                else:
                    views = [data]
                for vi, piece in enumerate(views):
                    with cond:
                        while retained[0] >= limit and not stop.is_set():
                            cond.wait(1.0)
                    if stop.is_set():
                        return
                    fl = flush_f and vi == len(views) - 1
                    _t0 = _time.time()
                    appended = eng.encode_text(
                        piece, fmt=cfg.fmt, flush=fl
                    )
                    phases["encode"] += _time.time() - _t0
                    if appended:
                        with cond:
                            retained[0] += appended
                        q.put(appended)
        except BaseException as e:  # pragma: no cover
            producer_err.append(e)
        finally:
            q.put(SENTINEL)

    idx_lock = threading.Lock()
    emq: "_queue.Queue[object]" = _queue.Queue(maxsize=2)
    emit_err: list[BaseException] = []
    cleared = [0]

    def emit_window(win: dict) -> None:
        # Materialize device results (slow fetch — outside idx_lock).
        texts: dict[int, str] = {}
        host_idx: list[int] = list(win["fallback"])
        for part, dev, bkey, caps in win["batches"]:
            _t0 = _time.time()
            o = {k: np.asarray(v) for k, v in dev.items()}
            _t1 = _time.time()
            phases["fetch"] += _t1 - _t0
            w_adapt(
                bkey, caps, int(o["wneed"].max()),
                int(o["nlong"].max()), int(o["nv"].max()),
            )
            bk = o["bk"]
            bases_all = bk & 0x7F
            kept_all = bk >= 128
            for j, i in enumerate(part):
                if o["flags"][j] or o["ambiguous"][j] or o["overflow"][j]:
                    host_idx.append(i)
                else:
                    res = devemit.assemble_fragments(
                        bases_all[j], kept_all[j], o["bbpos"][j],
                        int(o["path_len"][j]), cfg.min_length,
                    )
                    texts[i] = format_fasta(win["sids"][i], res)
            phases["assemble"] += _time.time() - _t1
        _t1 = _time.time()
        with idx_lock:
            # This window's targets sit at retained indices
            # 0..count-1 now (windows emit in submit order and each
            # clears its own).
            for i in host_idx:
                stats.host_fallbacks += 1
                texts[i] = eng.enc_consensus(i)
            for i in range(win["count"]):
                text = texts.get(i, "")
                if text:
                    out.stream.write(text)
                    stats.fragments += text.count(">")
                    stats.consensus_bases += sum(
                        len(l) for l in text.splitlines()
                        if not l.startswith(">")
                    )
                if journal is not None:
                    journal.mark(win["sids"][i])
            eng.enc_clear(win["count"])
            win["_cleared"][0] += win["count"]
        phases["write"] += _time.time() - _t1

    def emitter() -> None:
        try:
            while True:
                w = emq.get()
                if w is SENTINEL:
                    return
                emit_window(w)  # type: ignore[arg-type]
                with cond:
                    retained[0] -= w["count"]  # type: ignore[index]
                    cond.notify()
        except BaseException as e:  # pragma: no cover
            emit_err.append(e)
            while True:  # drain so the main thread's put() never blocks
                w = emq.get()
                if w is SENTINEL:
                    return

    def submit_window_caps(bkey, sub, prof):
        return choose_window_caps(
            bkey, sub, prof, w_state, v_state, _NEED_RECENT
        )

    def submit_window(offset: int, count: int) -> dict:
        """Bucket + dispatch one window (targets at engine indices
        offset..offset+count-1). Indices inside the returned work are
        window-relative."""
        metas = eng.enc_metas(count, offset=offset)
        sids = [eng.enc_sid(offset + i) for i in range(count)]
        tot_ins = int(metas[:, 3].sum())
        tot_cols = int(metas[:, 4].sum())
        prof = (
            DevCapsConfig.compact()
            if tot_ins <= 0.11 * max(1, tot_cols)
            else DevCapsConfig.heavy()
        )
        buckets: dict[tuple, list[int]] = {}
        fallback: list[int] = []
        for i in range(count):
            R, C, L, NI, _tc = (int(x) for x in metas[i, :5])
            Rb = _ladder(max(R, 1), _R_LADDER)
            Cb = _ladder(max(C, 1), _C_LADDER)
            Lb = _ladder(max(L, 1), _L_LADDER)
            if Rb is None or Cb is None or Lb is None:
                fallback.append(i)
            else:
                buckets.setdefault((Rb, Cb, Lb), []).append(i)
        batches: list[tuple[list[int], dict]] = []
        for (Rb, Cb, Lb), idxs in buckets.items():
            sub = metas[idxs]
            bkey = (Rb, Cb, Lb, prof.W)
            caps = submit_window_caps(bkey, sub, prof)
            NI = ins_cap(caps)
            fallback.extend(
                i for i in idxs if int(metas[i, 3]) > NI
            )
            idxs = [i for i in idxs if int(metas[i, 3]) <= NI]
            P = min(caps.V, 2 * caps.L + 64)
            step = full_step(caps, P)
            for lo in range(0, len(idxs), caps.B):
                part = idxs[lo : lo + caps.B]
                _t0 = _time.time()
                fill = (
                    eng.enc_fill_packed
                    if _PACK_OPS
                    else eng.enc_fill
                )
                ops, starts, bbuf, ins, Lrr = fill(
                    [offset + i for i in part],
                    caps.R, caps.C, caps.L, NI, B=caps.B,
                )
                _t1 = _time.time()
                phases["fill"] += _t1 - _t0
                d_in = (
                    jnp.asarray(ops), jnp.asarray(starts),
                    jnp.asarray(bbuf), jnp.asarray(ins),
                    jnp.asarray(Lrr),
                )
                _t2 = _time.time()
                phases["upload"] += _t2 - _t1
                dev = step(*d_in, jnp.int32(cfg.min_weight))
                phases["dispatch"] += _time.time() - _t2
                stats.batches += 1
                batches.append((part, dev, bkey, caps))
        return {
            "count": count,
            "sids": sids,
            "fallback": fallback,
            "batches": batches,
        }

    producer_thread = None
    try:
        t = threading.Thread(target=producer, daemon=True)
        producer_thread = (t, stop, cond)
        t.start()
        et = threading.Thread(target=emitter, daemon=True)
        et.start()
        submitted = 0
        avail = 0
        eof = False
        try:
            while not eof:
                item = q.get()
                while True:  # drain whatever else is already encoded
                    if item is SENTINEL:
                        eof = True
                    else:
                        avail += int(item)  # type: ignore[arg-type]
                        stats.targets += int(item)  # type: ignore[arg-type]
                    try:
                        item = q.get_nowait()
                    except _queue.Empty:
                        break
                while avail >= WIN or (eof and avail > 0):
                    cnt = min(WIN, avail)
                    with idx_lock:
                        win = submit_window(submitted - cleared[0], cnt)
                    submitted += cnt
                    avail -= cnt
                    win["_cleared"] = cleared
                    emq.put(win)
                    if emit_err:
                        raise emit_err[0]
        finally:
            emq.put(SENTINEL)
            et.join()
        t.join()
        if emit_err:
            raise emit_err[0]
        if producer_err:
            raise producer_err[0]
        if prof_on:
            import sys as _sys

            print(
                "devpipe prof: "
                + " ".join(f"{k}={v:.2f}s" for k, v in phases.items()),
                file=_sys.stderr, flush=True,
            )
        return stats
    finally:
        # On a main-thread error the producer may still be inside the
        # engine (or blocked on the retained-target cap); freeing the
        # engine under it is a use-after-free. Signal, unblock, join.
        if producer_thread is not None:
            _t, _stop, _cond = producer_thread
            _stop.set()
            with _cond:
                _cond.notify_all()
            _t.join(timeout=60)
        try:
            _, drec, dgrp = eng.status()
            stats.dropped_records += drec
            stats.dropped_groups += dgrp
            if drec or dgrp:
                log.warning(
                    "input loss: %d records skipped, %d groups dropped",
                    drec, dgrp,
                )
        except Exception:  # pragma: no cover
            pass
        eng.close()
