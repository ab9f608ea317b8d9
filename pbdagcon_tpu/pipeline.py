"""End-to-end consensus pipeline: stream -> groups -> graphs -> device DP
-> backtrack -> FASTA.

Accelerator replacement for the reference's threaded reader/worker/writer
pipeline (`src/cpp/main.cpp`, SURVEY.md §3.1 — reconstructed; mount
empty). Instead of per-target worker threads, targets are *batched*: each
target's merged graph is linearized host-side (natively when the C++
engine is built), batches are bucketed by padded size, and the weighted
best-path DP runs for the whole bucket at once on the accelerator. Exact
creation-order backtrack and fragment emission return to the host, so
output is bit-identical to the oracle regardless of backend.

Backends (`DagconConfig.backend`):
- "host":    pure host DP (no device) — reference-equivalent single path.
- "xla":     batched `lax.scan` DP (`ops/dp.py`).
- "blocked": max-plus blocked solve, sqrt(V) sequential depth
  (`ops/dp_blocked.py`), guarded bit-exact.
- "auto":    the hybrid scheduler on an accelerator with the native
  engine built, else the xla path.

Targets that overflow the largest (V, W, K) bucket fall back to the host
path — exactness is never sacrificed (SPEC.md §3.1).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Iterable, Iterator, TextIO

import numpy as np

from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter, TargetGroup, read_groups
from pbdagcon_tpu.oracle.graph import CnsResult
from pbdagcon_tpu.ops.dp import (
    LongEdgeOverflow,
    batch_scores,
    choose_layout,
    submit_packed_scores,
)
from pbdagcon_tpu.ops.linearize import (
    LinearGraph,
    backtrack,
    consensus_from_path,
    graph_from_group,
    host_scores,
    linearize,
)

log = logging.getLogger("pbdagcon_tpu")


@dataclasses.dataclass
class PipelineStats:
    """Counters mirroring the reference's log output, plus device-specifics."""

    targets: int = 0
    fragments: int = 0
    consensus_bases: int = 0
    host_fallbacks: int = 0
    batches: int = 0
    pad_nodes: int = 0  # padded - real nodes (pad-waste measure)
    real_nodes: int = 0
    # Loud-failure accounting: a genome-scale run must not lose input
    # invisibly. Records skipped (raw pair without -a) and groups dropped
    # (backbone recovery/build failed) are counted and logged.
    dropped_records: int = 0
    dropped_groups: int = 0
    # Hybrid-scheduler accounting: chunks/bytes/consensus-bases processed
    # by each worker plus per-worker busy seconds, so throughput can be
    # attributed to the chip vs the host cores honestly (the chip's
    # share is hybrid_dev_bases / hybrid_dev_busy_s).
    hybrid_host_chunks: int = 0
    hybrid_dev_chunks: int = 0
    hybrid_host_bytes: int = 0
    hybrid_dev_bytes: int = 0
    hybrid_host_bases: int = 0
    hybrid_dev_bases: int = 0
    hybrid_host_busy_s: float = 0.0
    hybrid_dev_busy_s: float = 0.0


def resolve_backend(cfg: DagconConfig) -> str:
    if cfg.backend != "auto":
        return cfg.backend
    try:
        import jax

        jax.devices()
    except Exception:  # pragma: no cover - no jax / no devices
        return "host"
    # run_stream upgrades "xla" to the hybrid scheduler on an
    # accelerator host with the native engine.
    return "xla"


def _bucket_of(x: int, ladder: tuple[int, ...]) -> int | None:
    for v in ladder:
        if x <= v:
            return v
    return None


def linearize_group(
    group: TargetGroup,
    cfg: DagconConfig,
    stats: PipelineStats | None = None,
) -> LinearGraph:
    """Normalize/trim, build + merge the graph, linearize (host side)."""
    alns = group.alns
    if cfg.align:
        from pbdagcon_tpu.aligner import align_record

        alns = [
            align_record(a, cfg.align_scorer, cfg.affine_params)
            for a in alns
        ]
    else:
        # Raw (ungapped) pairs without -a cannot be threaded; skip and
        # count them, matching the native engine's policy.
        kept = [a for a in alns if len(a.qstr) == len(a.tstr)]
        if len(kept) != len(alns):
            n_bad = len(alns) - len(kept)
            log.warning(
                "target %s: skipped %d raw record(s) without -a",
                group.sid, n_bad,
            )
            if stats is not None:
                stats.dropped_records += n_bad
            alns = kept
    g = graph_from_group(group.backbone, alns, trim=cfg.trim)
    return linearize(g, sid=group.sid)


def consensus_for_lin(
    lin: LinearGraph, scores, cfg: DagconConfig
) -> list[CnsResult]:
    path = backtrack(lin, scores)
    return consensus_from_path(lin, path, cfg.min_weight, cfg.min_length)


def _flush_bucket(
    lins: list[LinearGraph],
    V: int,
    cfg: DagconConfig,
    backend: str,
    stats: PipelineStats,
) -> Iterator[tuple[str, list[CnsResult]]]:
    """Run one padded bucket batch through the device DP."""
    try:
        W, K = choose_layout(lins, w_ladder=cfg.w_buckets)
        scores = batch_scores(lins, V, W, K, backend=backend)
    except LongEdgeOverflow:
        # Pathological targets: exact host DP, never wrong (SPEC §3.1).
        stats.host_fallbacks += len(lins)
        for lin in lins:
            yield lin.sid, consensus_for_lin(lin, host_scores(lin), cfg)
        return
    stats.batches += 1
    for i, lin in enumerate(lins):
        stats.pad_nodes += V - lin.n
        stats.real_nodes += lin.n
        yield lin.sid, consensus_for_lin(lin, scores[i, : lin.n], cfg)


def run_pipeline(
    groups: Iterable[TargetGroup],
    cfg: DagconConfig = DagconConfig(),
    stats: PipelineStats | None = None,
) -> Iterator[tuple[str, list[CnsResult]]]:
    """Consensus for a stream of target groups, in input order.

    Batches consecutive targets into per-V-bucket device batches of up to
    `cfg.batch_targets`; emits results in input order (the reference
    writer preserves order too).
    """
    stats = stats if stats is not None else PipelineStats()
    backend = resolve_backend(cfg)

    if backend == "host":
        for group in groups:
            lin = linearize_group(group, cfg, stats)
            stats.targets += 1
            res = consensus_for_lin(lin, host_scores(lin), cfg)
            stats.fragments += len(res)
            stats.consensus_bases += sum(len(r.seq) for r in res)
            yield group.sid, res
        return

    # Ordered batching: accumulate consecutive targets; flush when the
    # pending batch for a bucket is full. To preserve input order we
    # flush *all* pending work whenever any bucket fills.
    pending: list[tuple[LinearGraph | None, TargetGroup | None]] = []
    per_bucket: dict[int, int] = {}

    def flush() -> Iterator[tuple[str, list[CnsResult]]]:
        nonlocal pending, per_bucket
        # Key results by pending-list position, NOT sid: repeated,
        # non-consecutive target ids in one flush window are distinct
        # groups and must emit distinct results.
        buckets: dict[int, list[tuple[int, LinearGraph]]] = {}
        for pi, (lin, grp) in enumerate(pending):
            if lin is not None:
                V = _bucket_of(lin.n, cfg.v_buckets)
                assert V is not None
                buckets.setdefault(V, []).append((pi, lin))
        results: dict[int, list[CnsResult]] = {}
        for V, entries in buckets.items():
            lins = [l for _, l in entries]
            # _flush_bucket yields one result per lin, in order.
            for (pi, _), (_sid, res) in zip(
                entries, _flush_bucket(lins, V, cfg, backend, stats)
            ):
                results[pi] = res
        for pi, (lin, grp) in enumerate(pending):
            if lin is None:
                assert grp is not None
                stats.host_fallbacks += 1
                hl = linearize_group(grp, cfg, stats)
                res = consensus_for_lin(hl, host_scores(hl), cfg)
                sid = grp.sid
            else:
                sid = lin.sid
                res = results[pi]
            stats.fragments += len(res)
            stats.consensus_bases += sum(len(r.seq) for r in res)
            yield sid, res
        pending = []
        per_bucket = {}

    for group in groups:
        stats.targets += 1
        lin = linearize_group(group, cfg, stats)
        V = _bucket_of(lin.n, cfg.v_buckets)
        if V is None:
            pending.append((None, group))  # host fallback, keeps order
            continue
        pending.append((lin, None))
        per_bucket[V] = per_bucket.get(V, 0) + 1
        if per_bucket[V] >= cfg.batch_targets:
            yield from flush()
    yield from flush()


def device_align_stream(
    stream: TextIO | Iterable[str],
    fmt: str = "pre",
    batch_records: int = 1024,
) -> Iterator[str]:
    """Re-align raw record pairs on device in batches; yields gapped
    'pre' lines (order preserved). The `-a` hot stage moved to the
    device (ops/align_tpu.py); downstream consumers run without -a.

    Field-level rewriting (no record objects): a raw 'pre' record's
    start/end/tlen already describe the target window, and the gapped
    strings don't change them, so only fields 6/7 are replaced."""
    from pbdagcon_tpu.ops.align_tpu import align_batch

    if fmt != "pre":
        raise ValueError("device alignment requires raw 'pre' records")
    buf: list[list[str]] = []

    def flush(buf: list[list[str]]) -> Iterator[str]:
        gapped = align_batch([(f[5], f[6]) for f in buf])
        for f, (gq, gt) in zip(buf, gapped):
            yield (
                f"{f[0]} {f[1]} {f[2]} {f[3]} {f[4]} {gq} {gt}\n"
            )

    for line in stream:
        if isinstance(line, bytes):  # binary file/CLI streams
            line = line.decode()
        f = line.split()
        if not f:
            continue
        if len(f) != 7:
            raise ValueError(f"pre record has {len(f)} fields, expected 7")
        buf.append(f)
        if len(buf) >= batch_records:
            yield from flush(buf)
            buf = []
    if buf:
        yield from flush(buf)


def _native_engine(cfg: DagconConfig):
    """Native C++ engine if requested and built, else None."""
    if not cfg.use_native:
        return None
    from pbdagcon_tpu import native

    if not native.available():
        return None
    return native.NativeEngine(
        min_weight=cfg.min_weight,
        min_length=cfg.min_length,
        trim=cfg.trim,
        threads=cfg.threads,
        align=cfg.align,
        scorer=cfg.align_scorer,
        affine_params=cfg.affine_params,
    )


def _run_stream_native(
    stream: TextIO | Iterable[str],
    out: FastaWriter,
    cfg: DagconConfig,
    backend: str,
    stats: PipelineStats,
    chunk_bytes: int = 16 << 20,
    journal=None,
) -> PipelineStats:
    """Native-loader path: C++ parse/normalize/graph/linearize (threaded),
    device DP per bucket batch, native backtrack + FASTA emission.

    With backend == "host" the DP runs natively too and this is the
    reference-architecture-equivalent all-C++ path with Python only
    orchestrating IO chunks.
    """
    eng = _native_engine(cfg)
    assert eng is not None

    import os as _os

    chunk_bytes = int(
        _os.environ.get("DAGCON_CHUNK_MB", str(cfg.chunk_mb))
    ) << 20

    def chunks(chunk_bytes: int = chunk_bytes) -> Iterator[tuple[bytes, bool]]:
        if hasattr(stream, "read"):
            while True:
                buf = stream.read(chunk_bytes)  # type: ignore[union-attr]
                if not buf:
                    break
                yield buf.encode() if isinstance(buf, str) else buf, False
        else:
            acc: list[bytes] = []
            size = 0
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

    producer_thread = None  # set once the loader-mode producer starts
    try:
        if backend == "host":
            for data, flush in chunks():
                text = eng.consensus_text(data, fmt=cfg.fmt, flush=flush)
                if text:
                    out.stream.write(text)
                    stats.fragments += text.count(">")
                    stats.consensus_bases += sum(
                        len(l)
                        for l in text.splitlines()
                        if not l.startswith(">")
                    )
                    if journal is not None:
                        for l in text.splitlines():
                            if l.startswith(">"):
                                journal.mark(l[1:].rsplit("/", 1)[0])
            stats.targets = eng.targets_done
            return stats
        # Chunk pipelining: while the device computes chunk k's DP (and
        # Python emits it), the engine has already linearized chunk k+1
        # (graph building overlaps device work via async dispatch). The
        # engine retains exported targets until `clear_linears`.
        def submit_chunk(offset: int, count: int) -> dict:
            metas = eng.metas(count, offset=offset)
            ns = metas[:, 0]
            buckets: dict[int, list[int]] = {}
            for i in range(count):
                V = _bucket_of(int(ns[i]), cfg.v_buckets)
                buckets.setdefault(V if V is not None else -1, []).append(i)
            scores: dict[int, np.ndarray] = {}
            futures: list[tuple[list[int], object]] = []
            for V, idxs in buckets.items():
                if V < 0:
                    for i in idxs:  # out-of-bucket: colshard, else host
                        s = _colshard_oversize(eng, offset + i, int(ns[i]), cfg)
                        if s is not None:
                            stats.batches += 1
                            scores[i] = s
                        else:
                            stats.host_fallbacks += 1
                            scores[i] = eng.target_scores(
                                offset + i, int(ns[i])
                            )
                    continue
                abs_idxs = [offset + i for i in idxs]
                try:
                    from pbdagcon_tpu.ops.dp import _B_LADDER

                    W, K, outliers = _choose_layout_native(
                        eng, abs_idxs, cfg
                    )
                    if outliers:
                        for a in outliers:
                            i = a - offset
                            stats.host_fallbacks += 1
                            scores[i] = eng.target_scores(a, int(ns[i]))
                        idxs = [
                            i for i in idxs if offset + i not in outliers
                        ]
                    # Cap the per-dispatch batch (snapped DOWN to a pad
                    # ladder value so padding can't round back up) so
                    # the band tensor stays under the transfer cap
                    # (DagconConfig).
                    tcap = cfg.resolved_transfer_cap()
                    raw_cap = max(
                        32, min(cfg.batch_targets, tcap // (V * W * 2))
                    )
                    part_cap = max(
                        (b for b in _B_LADDER if b <= raw_cap), default=32
                    )
                    # Ladder decomposition balancing two real costs:
                    # padded rows are wasted upload bytes, but every
                    # extra dispatch pays a fixed round-trip cost.
                    # So: take largest-ladder parts while
                    # >= 128 targets remain, then pad the remainder up
                    # one ladder step — at most ~127 wasted rows, and
                    # a 154-target chunk uploads 128+32 rows instead
                    # of 256, in two dispatches instead of five.
                    parts: list[tuple[list[int], int]] = []
                    j0 = 0
                    while j0 < len(idxs):
                        rem = len(idxs) - j0
                        if rem >= min(128, part_cap):
                            take = max(
                                b for b in _B_LADDER
                                if b <= min(rem, part_cap)
                            )
                            parts.append((idxs[j0 : j0 + take], take))
                            j0 += take
                        else:
                            b = next(
                                bb for bb in _B_LADDER if bb >= rem
                            )
                            parts.append((idxs[j0:], min(b, part_cap)))
                            j0 = len(idxs)
                    for part, b_pad in parts:
                        import os as _os

                        if backend == "xla" and (
                            cfg.edge_upload
                            or _os.environ.get("DAGCON_EDGE_UPLOAD", "0")
                            == "1"
                        ):
                            # Edge-CSR arena: ~10x less upload; dense
                            # band scatter-reconstructed on device
                            # (opt-in).
                            tot_e = int(
                                sum(int(metas[i, 2]) for i in part)
                            )
                            e_pad = 1 << max(14, (tot_e - 1).bit_length())
                            batch = eng.pack_edges(
                                [offset + i for i in part], V, W, K,
                                b_pad=b_pad, e_pad=e_pad, x_pad=e_pad // 4,
                            )
                        else:
                            batch = eng.pack_batch(
                                [offset + i for i in part], V, W, K,
                                b_pad=b_pad,
                            )
                        fut = submit_packed_scores(batch, backend=backend)
                        stats.batches += 1
                        futures.append((part, fut))
                    for i in idxs:
                        stats.pad_nodes += V - int(ns[i])
                        stats.real_nodes += int(ns[i])
                except LongEdgeOverflow:
                    for i in idxs:
                        stats.host_fallbacks += 1
                        scores[i] = eng.target_scores(offset + i, int(ns[i]))
            return {
                "count": count,
                "ns": ns,
                "scores": scores,
                "futures": futures,
            }

        def emit_chunk(work: dict, idx_lock) -> None:
            # Materialize device scores (slow fetch — outside the index
            # lock), then emit. The work's targets sit at retained
            # indices 0..count-1 by emission time (works are emitted in
            # submit order and each clears its own targets).
            ns = work["ns"]
            scores = work["scores"]
            for idxs, fut in work["futures"]:
                sc = np.asarray(fut)
                for j, i in enumerate(idxs):
                    n = int(ns[i])
                    full = np.empty(n + 1, dtype=np.float32)
                    full[:n] = sc[j, :n]
                    full[n] = 0.0
                    scores[i] = full
            with idx_lock:
                for i in range(work["count"]):
                    text = eng.target_consensus(i, scores[i])
                    if text:
                        out.stream.write(text)
                        stats.fragments += text.count(">")
                        stats.consensus_bases += sum(
                            len(l)
                            for l in text.splitlines()
                            if not l.startswith(">")
                        )
                    if journal is not None:
                        journal.mark(eng.target_sid(i))
                eng.clear_linears(work["count"])
                work["_cleared"][0] += work["count"]

        # Producer thread runs the C++ parse/build/linearize in SMALL
        # text slices (ctypes releases the GIL) so linearized targets
        # become available early; the consumer dispatches the device
        # DP in fixed TARGET-COUNT bites (decoupled from text slicing
        # — every dispatch pays a fixed round-trip cost, so dispatch
        # size must not depend on where text-chunk boundaries happen to
        # fall). A retained-target cap gives
        # backpressure; at submit time exactly the unemitted works'
        # targets are retained, so retained indices stay aligned.
        import queue as _queue
        import threading

        q: "_queue.Queue[object]" = _queue.Queue()
        SENTINEL = object()
        producer_err: list[BaseException] = []
        stop = threading.Event()
        cond = threading.Condition()
        retained = [0]

        from pbdagcon_tpu.ops.dp import _B_LADDER

        Vmax = max(cfg.v_buckets)
        tcap = cfg.resolved_transfer_cap()
        dn = max(32, min(cfg.batch_targets, tcap // (Vmax * 16 * 2)))
        dispatch_n = max((b for b in _B_LADDER if b <= dn), default=32)
        limit = 3 * dispatch_n
        slice_bytes = min(chunk_bytes, 4 << 20)

        def producer() -> None:
            try:
                for data, flush in chunks(slice_bytes):
                    with cond:
                        while retained[0] >= limit and not stop.is_set():
                            cond.wait(1.0)
                    if stop.is_set():
                        return
                    appended = eng.linearize_text(
                        data, fmt=cfg.fmt, flush=flush
                    )
                    if appended:
                        with cond:
                            retained[0] += appended
                        q.put(appended)
            except BaseException as e:  # pragma: no cover
                producer_err.append(e)
            finally:
                q.put(SENTINEL)

        # Emitter thread: fetch+decode+emit of work k overlaps the
        # submit (pack+upload) of work k+1 and the producer's
        # linearize of k+2 — three-stage pipeline, one stage per
        # thread. `idx_lock` serializes retained-index access: the
        # engine's retained list shifts on clear, so submits (which
        # read metas/pack at offsets) and the emit+clear section must
        # not interleave. Fetch/decode stays outside the lock.
        idx_lock = threading.Lock()
        emq: "_queue.Queue[object]" = _queue.Queue(maxsize=2)
        emit_err: list[BaseException] = []

        def emitter() -> None:
            try:
                while True:
                    w = emq.get()
                    if w is SENTINEL:
                        return
                    emit_chunk(w, idx_lock)  # type: ignore[arg-type]
                    with cond:
                        retained[0] -= w["count"]  # type: ignore[index]
                        cond.notify()
            except BaseException as e:  # pragma: no cover
                emit_err.append(e)
                # Drain so the main thread's put() never deadlocks.
                while True:
                    w = emq.get()
                    if w is SENTINEL:
                        return

        t = threading.Thread(target=producer, daemon=True)
        producer_thread = (t, stop, cond)
        t.start()
        et = threading.Thread(target=emitter, daemon=True)
        et.start()
        cleared = [0]  # total targets emitted+cleared (under idx_lock)
        submitted = 0
        avail = 0
        eof = False
        try:
            while not eof:
                item = q.get()
                while True:  # drain whatever else is already linearized
                    if item is SENTINEL:
                        eof = True
                    else:
                        avail += int(item)  # type: ignore[arg-type]
                        stats.targets += int(item)  # type: ignore[arg-type]
                    try:
                        item = q.get_nowait()
                    except _queue.Empty:
                        break
                while avail >= dispatch_n or (eof and avail > 0):
                    cnt = min(dispatch_n, avail)
                    with idx_lock:
                        work = submit_chunk(submitted - cleared[0], cnt)
                    submitted += cnt
                    avail -= cnt
                    work["_cleared"] = cleared
                    emq.put(work)
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
        return stats
    finally:
        # On a main-thread error the producer may still be inside the
        # engine (or blocked on a slot); freeing the engine under it is
        # a use-after-free. Signal, unblock, and join before close.
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
        except Exception:  # pragma: no cover - status is best-effort
            pass
        eng.close()


def _colshard_oversize(
    eng, idx: int, n: int, cfg: DagconConfig
) -> np.ndarray | None:
    """Column-sharded DP for a target that overflows every V bucket
    (SURVEY.md §5 long-context row): shard the node axis over the device
    mesh with a ppermute boundary chain. Returns scores[n+1] or None
    when ineligible (long edges beyond the W ladder, int32 half-unit
    bound exceeded, scores past the f32-parity line, or no devices)."""
    try:
        import jax
        from jax.sharding import Mesh

        from pbdagcon_tpu.ops.dp_blocked import blocked_safe
        from pbdagcon_tpu.parallel.colshard import colsharded_scores

        devs = jax.devices()
        if not devs:
            return None
        lin = eng.get_linear(idx)
        W = next((w for w in cfg.w_buckets if lin.span <= w), None)
        if W is None:
            return None
        from pbdagcon_tpu.ops.dp import pad_batch

        D = len(devs)
        V = -(-max(lin.n, 1) // (64 * D)) * (64 * D)
        batch = pad_batch([lin], V, W, K=1)
        max_esc = max(
            float(np.abs(batch["cov"]).max(initial=0)) * 0.5
            + float(batch["win_count"].max(initial=0)),
            10.0,
        )
        if not blocked_safe(max_esc, V):
            return None
        mesh = Mesh(np.array(devs), ("targets",))
    except Exception:  # pragma: no cover - any failure -> exact host DP
        log.warning("colshard path failed; host fallback", exc_info=True)
        return None
    try:
        s = colsharded_scores(
            batch["win_count"][0].astype(np.int32),
            batch["exit_count"][0].astype(np.int32),
            batch["cov"][0].astype(np.int32),
            batch["unsup"][0],
            mesh,
        )
        full = np.empty(lin.n + 1, dtype=np.float32)
        full[: lin.n] = s[: lin.n]
        full[lin.n] = 0.0
        return full
    except OverflowError:  # past the f32-parity line: exact host DP
        return None
    except Exception:  # pragma: no cover - any failure -> exact host DP
        log.warning("colshard path failed; host fallback", exc_info=True)
        return None


def _choose_layout_native(
    eng, idxs: list[int], cfg: DagconConfig
) -> tuple[int, int, set[int]]:
    """choose_layout on native long-edge counts (no array export).

    Returns (W, K, outliers). The long-edge register file costs
    O(B*V*K) device work, so K is capped; the few targets whose
    long-edge count exceeds the cap at every W go to the host fallback
    instead of inflating the whole batch (they'd multiply everyone's
    DP cost)."""
    w_ladder = cfg.w_buckets
    k_ladder = (8, 32, 128)
    counts = {i: eng.long_counts(i, w_ladder) for i in idxs}
    k_cap = k_ladder[-1]
    outliers = {
        i for i in idxs if all(c > k_cap for c in counts[i])
    }
    fit = [i for i in idxs if i not in outliers]
    best = None
    best_cost = None
    for wi, W in enumerate(w_ladder):
        worst = max((int(counts[i][wi]) for i in fit), default=0)
        K = next((k for k in k_ladder if k >= worst), None)
        if K is None:
            continue
        cost = 2 * W + K / 2
        if best_cost is None or cost < best_cost:
            best, best_cost = (W, K), cost
    if best is None:
        # No single (W, K) fits everyone: push per-target misfits out.
        W = w_ladder[-1]
        for i in fit:
            if counts[i][-1] > k_cap:
                outliers.add(i)
        best = (W, k_cap)
    return best[0], best[1], outliers


def run_stream(
    stream: TextIO | Iterable[str],
    out: FastaWriter,
    cfg: DagconConfig = DagconConfig(),
    journal=None,
) -> PipelineStats:
    """Reference-CLI-equivalent entry: M5/'pre' text stream in, FASTA out."""
    from pbdagcon_tpu.config import enable_compile_cache

    enable_compile_cache()
    stats = PipelineStats()
    backend = resolve_backend(cfg)
    if cfg.backend == "auto" and backend == "xla" and cfg.use_native:
        # On a real accelerator with the native engine present, the
        # additive hybrid scheduler dominates: it is never materially
        # slower than the pure host engine (rate-adaptive stealing
        # tapers a slow device to zero) and strictly faster when the
        # chip helps. Keep CPU-only hosts on the xla path — there the
        # "device" is the same cores the host engine runs on.
        # DAGCON_AUTO_HYBRID=0 opts default runs out (e.g. while soaking
        # the scheduler on new hardware); --backend overrides either way.
        try:
            import jax

            if (
                jax.devices()[0].platform != "cpu"
                and os.environ.get("DAGCON_AUTO_HYBRID", "1") != "0"
            ):
                from pbdagcon_tpu import native as _native

                if _native.available():
                    backend = "hybrid"
                    log.warning(
                        "backend=auto resolved to the hybrid scheduler "
                        "(host engine + device pipeline); set "
                        "DAGCON_AUTO_HYBRID=0 or --backend to override"
                    )
        except Exception:  # pragma: no cover - no jax / no devices
            pass
    log.info("backend: %s resolved to %s", cfg.backend, backend)
    if backend == "hybrid":
        from pbdagcon_tpu import native as _native

        have_native = cfg.use_native and _native.available()
        try:
            import jax

            have_dev = bool(jax.devices())
        except Exception:  # pragma: no cover - no jax / no devices
            have_dev = False
        if have_native and have_dev:
            from pbdagcon_tpu.hybrid import run_stream_hybrid

            run_stream_hybrid(stream, out, cfg, stats, journal=journal)
            log.info(
                "hybrid: targets=%d fragments=%d bases=%d batches=%d "
                "host_fallbacks=%d",
                stats.targets, stats.fragments, stats.consensus_bases,
                stats.batches, stats.host_fallbacks,
            )
            return stats
        # Degrade: no native engine or no device — take the best
        # single-worker path available instead.
        backend = "host" if have_native else "xla"
    if backend == "devbuild":
        from pbdagcon_tpu import native as _native
        from pbdagcon_tpu.devpipe import (
            run_devbuild_native,
            run_devbuild_pipeline,
        )

        if cfg.use_native and _native.available():
            run_devbuild_native(stream, out, cfg, stats, journal=journal)
        else:
            for sid, results in run_devbuild_pipeline(
                read_groups(stream, cfg.fmt), cfg, stats
            ):
                out.write_target(sid, results)
                if journal is not None:
                    journal.mark(sid)
        log.info(
            "devbuild: targets=%d fragments=%d bases=%d batches=%d "
            "host_fallbacks=%d",
            stats.targets, stats.fragments, stats.consensus_bases,
            stats.batches, stats.host_fallbacks,
        )
        return stats
    if (
        cfg.align
        and cfg.align_backend == "device"
        and backend in ("xla", "blocked")
        and cfg.fmt == "pre"
    ):
        # Device re-alignment: transform the raw stream up front, then
        # run the rest of the pipeline on gapped records without -a.
        stream = device_align_stream(stream, cfg.fmt)
        cfg = dataclasses.replace(cfg, align=False)
    used_native = False
    if cfg.use_native:
        from pbdagcon_tpu import native as _native

        if _native.available():
            _run_stream_native(
                stream, out, cfg, backend, stats, journal=journal
            )
            used_native = True
    if not used_native:
        for sid, results in run_pipeline(
            read_groups(stream, cfg.fmt), cfg, stats
        ):
            out.write_target(sid, results)
            if journal is not None:
                journal.mark(sid)
    log.info(
        "targets=%d fragments=%d bases=%d batches=%d host_fallbacks=%d "
        "pad_waste=%.1f%%",
        stats.targets,
        stats.fragments,
        stats.consensus_bases,
        stats.batches,
        stats.host_fallbacks,
        100.0
        * stats.pad_nodes
        / max(1, stats.pad_nodes + stats.real_nodes),
    )
    return stats
