"""tpu-dagcon benchmark: consensus bases/sec/chip vs single-core C++.

Measures the end-to-end pipeline (native C++ parse/normalize/graph/
linearize -> batched DP on device -> native backtrack/FASTA)
on simulated pileups matching BASELINE.json config #2 (batched
multi-target consensus), and compares against the single-threaded native
C++ host engine — the stand-in for the reference `dagcon` single-core
baseline (the reference mount is empty; BASELINE.md explains, and the
native engine implements the identical algorithm, so this is the honest
"1 CPU core C++" anchor the north star's 10x target refers to).

The headline value is CHIP-ATTRIBUTABLE throughput: the best of the
xla device-DP path, the all-on-device devbuild path, and the hybrid
scheduler's device-worker share (bases the device produced over its own
busy seconds). Host-dominated aggregates (hybrid total, host all-thread)
are secondary fields, never the headline. Multi-run rates carry
min/median/max spread; `value` and `vs_baseline` use medians.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "bases/s", "vs_baseline": N}
Progress goes to stderr. Scale via env: BENCH_TARGETS, BENCH_LEN,
BENCH_COV.
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    n_targets = int(os.environ.get("BENCH_TARGETS", "512"))
    length = int(os.environ.get("BENCH_LEN", "1000"))
    cov = int(os.environ.get("BENCH_COV", "30"))

    import jax

    from pbdagcon_tpu.config import enable_compile_cache

    enable_compile_cache()
    platform = jax.devices()[0].platform
    log(f"bench: platform={platform} devices={len(jax.devices())}")

    from pbdagcon_tpu import native
    from pbdagcon_tpu.config import DagconConfig
    from pbdagcon_tpu.io import FastaWriter
    from pbdagcon_tpu.pipeline import PipelineStats, _run_stream_native, run_stream
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_m5

    if not native.ensure_built():
        log("FATAL: native engine failed to build")
        return 1

    mode = os.environ.get("BENCH_MODE", "align")

    # ---- generate workload (excluded from timing) ----
    t0 = time.time()
    from pbdagcon_tpu.simulate import to_pre_raw

    lines: list[str] = []
    for _tid, _bb, alns in simulate_targets(
        1234, n_targets, length, cov, NoiseProfile()
    ):
        if mode == "align":
            lines.extend(to_pre_raw(a) for a in alns)
        else:
            lines.extend(to_m5(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()
    log(
        f"bench: mode={mode} generated {n_targets} targets x {length}bp x "
        f"{cov}x ({len(text)/1e6:.1f} MB) in {time.time()-t0:.1f}s"
    )

    backend = os.environ.get("BENCH_BACKEND", "xla")

    # Probe a few targets to size the single V bucket for this workload
    # (one compiled kernel shape; depth moves node counts a lot).
    with native.NativeEngine(
        min_weight=max(2, cov // 4), min_length=100,
        threads=os.cpu_count() or 4, align=mode == "align",
    ) as probe:
        probe_text = "\n".join(lines[: 12 * cov]).encode() + b"\n"
        cnt = probe.linearize_text(
            probe_text, fmt="pre" if mode == "align" else "m5"
        )
        max_n = int(probe.metas(cnt)[:, 0].max()) if cnt else 4096
    v_bucket = -(-int(max_n * 1.3) // 256) * 256
    log(f"bench: probe max_n={max_n} -> V bucket {v_bucket}")

    cfg = DagconConfig(
        min_weight=max(2, cov // 4),
        min_length=100,
        threads=os.cpu_count() or 8,
        backend=backend,
        batch_targets=512,
        fmt="pre" if mode == "align" else "m5",
        align=mode == "align",
        v_buckets=(v_bucket,),
        w_buckets=(16, 32, 64),
    )

    def run_device() -> tuple[float, PipelineStats, str]:
        out = io.StringIO()
        t = time.time()
        # run_stream engages device re-alignment (align mode) and the
        # native loader + device DP path.
        stats = run_stream(
            io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg
        )
        fasta = out.getvalue()
        stats.consensus_bases = sum(
            len(l) for l in fasta.splitlines() if not l.startswith(">")
        )
        return time.time() - t, stats, fasta

    def spread(rates: list[float]) -> dict:
        """min/median/max of >= 1 runs (VERDICT r2 #10: report the
        spread, cite the median — this box is contended)."""
        rs = sorted(rates)
        return {
            "min": round(rs[0], 1),
            "median": round(rs[len(rs) // 2], 1),
            "max": round(rs[-1], 1),
        }

    # Warmup (compiles all bucket shapes), then measure steady state.
    log("bench: warmup (compiling device DP buckets)...")
    t0 = time.time()
    _dt, stats, fasta_dev = run_device()
    log(
        f"bench: warmup done in {time.time()-t0:.1f}s "
        f"(targets={stats.targets} batches={stats.batches} "
        f"fallbacks={stats.host_fallbacks})"
    )
    device_bases = stats.consensus_bases
    dev_rates = []
    for rep in range(3):
        dt, stats, fasta_dev = run_device()
        log(f"bench: device run {rep}: {dt:.2f}s")
        dev_rates.append(stats.consensus_bases / dt)
    xla_spread = spread(dev_rates)
    device_rate = xla_spread["median"]

    # ---- single-core C++ baseline (reference stand-in) ----
    log("bench: single-core native C++ baseline...")
    base_rates = []
    for rep in range(3):
        with native.NativeEngine(
            min_weight=cfg.min_weight, min_length=cfg.min_length,
            threads=1, align=cfg.align,
        ) as eng:
            t = time.time()
            fasta_host = eng.consensus_text(text, fmt=cfg.fmt)
            dt = time.time() - t
        log(f"bench: baseline run {rep}: {dt:.2f}s")
        base_rates.append(
            sum(
                len(l) for l in fasta_host.splitlines()
                if not l.startswith(">")
            )
            / dt
        )
    base_spread = spread(base_rates)
    base_rate = base_spread["median"]
    base_bases = sum(
        len(l) for l in fasta_host.splitlines() if not l.startswith(">")
    )

    if fasta_dev != fasta_host:
        log("FATAL: device FASTA != single-core C++ FASTA (parity broken)")
        return 1

    # ---- all-threads host mode (framework's best on this box) ----
    with native.NativeEngine(
        min_weight=cfg.min_weight, min_length=cfg.min_length,
        threads=cfg.threads, align=cfg.align,
    ) as eng:
        t = time.time()
        fasta_mt = eng.consensus_text(text, fmt=cfg.fmt)
        mt_dt = time.time() - t
    host_mt_rate = base_bases / mt_dt
    if fasta_mt != fasta_host:
        log("FATAL: multithreaded FASTA != single-core FASTA")
        return 1
    log(f"bench: host {cfg.threads}-thread: {mt_dt:.2f}s "
        f"({host_mt_rate:,.0f} b/s)")

    # ---- round-2: all-on-device graph build (backend=devbuild) ----
    # Graph build + merge + DP + backtrack on the chip; host only
    # parses/normalizes/encodes. One timed run (compiles are cached by
    # the first); disable with BENCH_DEVBUILD=0.
    devbuild_rate = 0.0
    devbuild_spread = None
    if os.environ.get("BENCH_DEVBUILD", "1") == "1":
        try:
            dcfg = DagconConfig(
                min_weight=cfg.min_weight, min_length=cfg.min_length,
                threads=cfg.threads, backend="devbuild", fmt=cfg.fmt,
                # One window per 128-target batch (the top B rung):
                # host encode of window k+1 then overlaps the device
                # compute of window k. One giant window serializes the
                # whole encode in front of the first dispatch (measured
                # 107k -> 130k b/s).
                align=cfg.align, batch_targets=128,
            )
            out = io.StringIO()
            run_stream(  # warmup/compile
                io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), dcfg
            )
            db_rates = []
            for rep in range(3):
                out = io.StringIO()
                t = time.time()
                dstats = run_stream(
                    io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out),
                    dcfg,
                )
                ddt = time.time() - t
                fasta_db = out.getvalue()
                db_bases = sum(
                    len(l) for l in fasta_db.splitlines()
                    if not l.startswith(">")
                )
                db_rates.append(db_bases / ddt)
            devbuild_spread = spread(db_rates)
            devbuild_rate = devbuild_spread["median"]
            parity = "OK" if fasta_db == fasta_dev else "MISMATCH"
            log(
                f"bench: devbuild path {devbuild_rate:,.0f} b/s "
                f"(fallbacks={dstats.host_fallbacks}/{dstats.targets}, "
                f"parity {parity})"
            )
        except Exception as e:  # pragma: no cover
            log(f"bench: devbuild metric skipped ({e})")

    # ---- devbuild execute-only (VERDICT r2 #1b-ii) ----
    # The full build+DP+backtrack step chained K times inside ONE jit
    # over resident inputs, one scalar fetch: isolates the device's
    # execute time from dispatch and transfer costs.
    devbuild_exec_rate = 0.0
    if os.environ.get("BENCH_DEVBUILD_EXEC", "1") == "1":
        try:
            import jax as _jx
            import jax.numpy as jnp
            import numpy as np

            from pbdagcon_tpu.devpipe import (
                DevCapsConfig, _C_LADDER, _L_LADDER, _R_LADDER, _ladder,
                caps_for, ins_cap, step_programs,
            )
            from pbdagcon_tpu.ops.devbuild_jax import device_build

            with native.NativeEngine(
                min_weight=cfg.min_weight, min_length=cfg.min_length,
                threads=cfg.threads, align=cfg.align,
            ) as eng:
                count = eng.encode_text(text, fmt=cfg.fmt, flush=True)
                metas = eng.enc_metas(count)
                tot_ins = int(metas[:, 3].sum())
                tot_cols = int(metas[:, 4].sum())
                dcap = (
                    DevCapsConfig.compact()
                    if tot_ins <= 0.11 * max(1, tot_cols)
                    else DevCapsConfig.heavy()
                )
                caps = caps_for(
                    128,
                    _ladder(int(metas[:, 0].max()), _R_LADDER),
                    _ladder(int(metas[:, 1].max()), _C_LADDER),
                    _ladder(int(metas[:, 2].max()), _L_LADDER),
                    dcap,
                    ch_need=int(metas[:, 5].max()),
                    sm_need=int(metas[:, 6].max()),
                    nd_need=int(metas[:, 3].max()),
                    dq_need=int(metas[:, 7].max()),
                    se_need=int(metas[:, 8].max()),
                    # the rungs the adaptive pipeline settles on for
                    # this workload: W off 48 via K-file pressure, V at
                    # the measured node count + the pipeline's 12%
                    # headroom (max_n from the host probe above IS the
                    # per-target linear-graph size the build measures).
                    w_need=64,
                    v_need=int(1.12 * max_n) + 1,
                )
                NI = ins_cap(caps)
                part = [
                    i for i in range(count) if int(metas[i, 3]) <= NI
                ][: caps.B]
                arrs = eng.enc_fill(
                    part, caps.R, caps.C, caps.L, NI, B=caps.B
                )
                dev_in = tuple(
                    _jx.device_put(np.asarray(a)) for a in arrs
                )
                _jx.block_until_ready(dev_in[0])
                Pw = min(caps.V, 2 * caps.L + 64)
                KREP = 3

                # the production DP + backtrack program (devpipe's
                # DP routing included)
                _build, dp_emit = step_programs(caps, Pw)
                mw = jnp.int32(cfg.min_weight)

                @_jx.jit
                def _exec_chain(ops_, starts_, bbuf_, ins_, Lr_):
                    tot = jnp.int32(0)
                    o = ops_
                    for _ in range(KREP):
                        b = device_build(
                            o, starts_, bbuf_, ins_, Lr_, caps
                        )
                        e = dp_emit(b, mw)
                        pl = jnp.sum(e["path_len"]).astype(jnp.int32)
                        tot = tot + pl
                        # value-zero, not provably-zero dependency so
                        # XLA cannot CSE the iterations into one step.
                        o = o ^ jnp.equal(pl, -1234567).astype(o.dtype)
                    return tot

                int(_exec_chain(*dev_in))  # compile + warm
                t = time.time()
                int(_exec_chain(*dev_in))
                dt_exec = time.time() - t
                # consensus bases produced by this window per step
                win_bases = len(part) * length
                devbuild_exec_rate = win_bases * KREP / dt_exec
                log(
                    f"bench: devbuild execute-only "
                    f"{devbuild_exec_rate:,.0f} b/s "
                    f"({KREP} chained steps, {len(part)} targets, "
                    f"{dt_exec:.2f}s)"
                )
        except Exception as e:  # pragma: no cover
            log(f"bench: devbuild execute metric skipped ({e})")

    # ---- round-2: additive hybrid scheduler (backend=hybrid) ----
    # Host engine and devbuild pipeline run concurrently on group-
    # aligned chunks (rate-adaptive stealing): the chip ADDS throughput
    # on top of the host cores instead of replacing cheap host stages.
    # A 512-target stream is ~1s of host work — the probe deferral
    # keeps the device idle on it. Measure hybrid
    # on a longer stream (steady-state, where mid-stream stealing
    # operates), and verify parity against the host engine on the SAME
    # stream.
    hybrid_rate = 0.0
    hybrid_dev_attr_rate = 0.0
    hybrid_host_engine_rate = 0.0
    hybrid_dev_chunks = 0
    hy_targets = int(os.environ.get("BENCH_HYBRID_TARGETS", "2048"))
    if os.environ.get("BENCH_HYBRID", "1") == "1":
        try:
            hy_lines: list[str] = []
            for _tid, _bb, alns in simulate_targets(
                4321, hy_targets, length, cov, NoiseProfile()
            ):
                if mode == "align":
                    hy_lines.extend(to_pre_raw(a) for a in alns)
                else:
                    hy_lines.extend(to_m5(a) for a in alns)
            hy_text = ("\n".join(hy_lines) + "\n").encode()
            del hy_lines
            hcfg = DagconConfig(
                min_weight=cfg.min_weight, min_length=cfg.min_length,
                threads=cfg.threads, backend="hybrid", fmt=cfg.fmt,
                align=cfg.align, batch_targets=cfg.batch_targets,
            )
            out = io.StringIO()
            # Warmup on the SAME stream: the device probe chunk's caps
            # depend on the exact chunk composition, so warming on a
            # different stream leaves its shapes uncompiled and a
            # first-ever jit (~80s) lands inside the timed run.
            run_stream(
                io.TextIOWrapper(io.BytesIO(hy_text)), FastaWriter(out),
                hcfg,
            )
            out = io.StringIO()
            t = time.time()
            hstats = run_stream(
                io.TextIOWrapper(io.BytesIO(hy_text)), FastaWriter(out),
                hcfg,
            )
            hdt = time.time() - t
            fasta_hy = out.getvalue()
            hy_bases = sum(
                len(l) for l in fasta_hy.splitlines()
                if not l.startswith(">")
            )
            hybrid_rate = hy_bases / hdt
            hybrid_dev_chunks = hstats.hybrid_dev_chunks
            # Chip-attributable share of the hybrid run: bases the
            # device worker produced over its own busy time (NOT the
            # host-dominated aggregate — VERDICT r2 #1b / ADVICE r2).
            if hstats.hybrid_dev_busy_s > 0:
                hybrid_dev_attr_rate = (
                    hstats.hybrid_dev_bases / hstats.hybrid_dev_busy_s
                )
            # Host engine on the SAME stream (the parity run, timed) so
            # hybrid-vs-host is apples-to-apples.
            with native.NativeEngine(
                min_weight=cfg.min_weight, min_length=cfg.min_length,
                threads=cfg.threads, align=cfg.align,
            ) as heng:
                t = time.time()
                fasta_hy_host = heng.consensus_text(hy_text, fmt=cfg.fmt)
                hybrid_host_engine_rate = hy_bases / (time.time() - t)
            parity = "OK" if fasta_hy == fasta_hy_host else "MISMATCH"
            log(
                f"bench: hybrid path ({hy_targets} targets) "
                f"{hybrid_rate:,.0f} b/s aggregate "
                f"(device-attributable {hybrid_dev_attr_rate:,.0f} b/s, "
                f"host engine same-stream {hybrid_host_engine_rate:,.0f} "
                f"b/s; host_chunks={hstats.hybrid_host_chunks} "
                f"dev_chunks={hstats.hybrid_dev_chunks}, parity {parity})"
            )
            if parity != "OK":
                log("FATAL: hybrid FASTA != host-engine FASTA")
                return 1
        except Exception as e:  # pragma: no cover
            log(f"bench: hybrid metric skipped ({e})")

    # ---- kernel-level metric: consensus DP, device vs one host core ----
    # (the stage the chip owns; end-to-end is host-bound on this 4-core
    # dev box, so the per-stage ratio shows the chip's real headroom)
    import numpy as np

    from pbdagcon_tpu.ops.dp import submit_packed_scores
    from pbdagcon_tpu.pipeline import _choose_layout_native

    dp_dev_rate = dp_host_rate = dp_exec_rate = 0.0
    try:
        with native.NativeEngine(
            min_weight=cfg.min_weight, min_length=cfg.min_length,
            threads=cfg.threads, align=cfg.align,
        ) as eng:
            count = eng.linearize_text(text, fmt=cfg.fmt)
            idxs = list(range(min(count, 256)))  # keep transfers <48MB
            W, K, outliers = _choose_layout_native(eng, idxs, cfg)
            idxs = [i for i in idxs if i not in outliers]
            V = cfg.v_buckets[0]
            batch = eng.pack_batch(idxs, V, W, K, b_pad=256)
            # Resident-input timing: in the pipeline, uploads overlap
            # compute (async dispatch + producer thread); what the chip
            # exposes per batch is execute + packed fetch.
            import jax.numpy as jnp

            from pbdagcon_tpu.ops.dp import _compress_scores, dp_scores

            args = tuple(
                jnp.asarray(batch[k])
                for k in (
                    "win_count", "exit_count", "cov", "unsup",
                    "long_u", "long_w", "long_esc",
                )
            )
            np.asarray(_compress_scores(dp_scores(*args)))  # warm
            t = time.time()
            reps = 3
            for _ in range(reps):
                np.asarray(_compress_scores(dp_scores(*args)))
            dp_dev_rate = len(idxs) * reps / (time.time() - t)
            # Execute-only rate: N chained solves, ONE scalar fetch at
            # the end — isolates the device from per-transfer costs
            # (which overlap with compute in the real pipeline).
            import jax as _jax

            from pbdagcon_tpu.ops.dp import _solve as _dp_solve
            from pbdagcon_tpu.ops.dp import arena_solver

            # Production routing (the xla path's solver rule).
            V_ = batch["win_count"].shape[1]
            solver = arena_solver(batch, V_)
            _solve = lambda *a: _dp_solve(a, V_, solver)[0]

            @_jax.jit
            def _chained(*a):
                s = jnp.float32(0)
                arrs = list(a)
                for _ in range(20):
                    sc = _solve(*arrs)
                    s = s + jnp.sum(jnp.where(jnp.isfinite(sc), sc, 0))
                    # Value-0 data dependency so XLA cannot CSE the
                    # iterations into one solve (s - s is not foldable
                    # under IEEE semantics: s might be non-finite).
                    arrs[1] = arrs[1] + (s - s).astype(arrs[1].dtype)
                return s

            float(_chained(*args))  # warm/compile
            t = time.time()
            float(_chained(*args))
            dp_exec_rate = len(idxs) * 20 / (time.time() - t)
            t = time.time()
            nh = min(64, count)
            metas = eng.metas(nh)
            for i in range(nh):
                eng.target_scores(i, int(metas[i, 0]))
            dp_host_rate = nh / (time.time() - t)
        log(
            f"bench: DP stage device(resident)={dp_dev_rate:,.0f} targets/s "
            f"device(execute)={dp_exec_rate:,.0f} targets/s "
            f"1-core-host={dp_host_rate:,.0f} targets/s "
            f"(execute {dp_exec_rate/max(dp_host_rate,1e-9):.1f}x)"
        )
    except Exception as e:  # pragma: no cover
        log(f"bench: DP stage metric skipped ({e})")
    log(
        f"bench: parity OK ({device_bases} consensus bases). "
        f"device={device_rate:,.0f} b/s single-core-C++={base_rate:,.0f} b/s"
    )

    # Headline: the fastest CHIP-ATTRIBUTABLE production rate (VERDICT
    # r2 #1b): end-to-end modes where the device does the DP or the
    # whole graph step, or the hybrid's device-worker share measured
    # over its own busy time. The host-dominated hybrid aggregate and
    # the all-threads host rate are reported as secondary fields only.
    head_rate, head_backend = max(
        (device_rate, backend),
        (devbuild_rate, "devbuild"),
        (hybrid_dev_attr_rate, "hybrid-device-share"),
    )
    print(
        json.dumps(
            {
                "metric": "consensus_bases_per_sec_per_chip",
                "value": round(head_rate, 1),
                "unit": "bases/s",
                "vs_baseline": round(head_rate / base_rate, 3),
                "platform": platform,
                "backend": head_backend,
                "mode": mode,
                "targets": n_targets,
                "coverage": cov,
                "backbone_len": length,
                "baseline": "native C++ engine, 1 thread (reference stand-in)",
                "baseline_bases_per_s": base_spread,
                "parity": "device FASTA == single-core FASTA",
                "dp_device_targets_per_s_resident": round(dp_dev_rate, 1),
                "dp_device_targets_per_s_execute": round(dp_exec_rate, 1),
                "dp_host_1core_targets_per_s": round(dp_host_rate, 1),
                "devbuild_bases_per_s": devbuild_spread,
                "devbuild_execute_bases_per_s": round(
                    devbuild_exec_rate, 1
                ),
                "xla_path_bases_per_s": xla_spread,
                "hybrid_device_share_bases_per_s": round(
                    hybrid_dev_attr_rate, 1
                ),
                "hybrid_aggregate_bases_per_s": round(hybrid_rate, 1),
                "hybrid_host_engine_same_stream_bases_per_s": round(
                    hybrid_host_engine_rate, 1
                ),
                "hybrid_dev_chunks": hybrid_dev_chunks,
                "hybrid_targets": hy_targets,
                # never-worse guard (VERDICT r3 #7 / r4 #4): hybrid
                # must stay within 10% of the host-only engine on the
                # SAME stream; a False here is a CI-red regression
                # signal. With dev_chunks == 0 the scheduler already
                # collapsed to host-only (round-5 probe deferral), so
                # the ratio is the same code measured twice — a noise
                # reading, reported but not a guard signal (this box's
                # back-to-back spread exceeds the 10% threshold).
                "hybrid_vs_host_ratio": round(
                    hybrid_rate / hybrid_host_engine_rate, 3
                ) if hybrid_host_engine_rate > 0 else None,
                "hybrid_guard_ok": bool(
                    hybrid_host_engine_rate <= 0
                    or hybrid_dev_chunks == 0
                    or hybrid_rate >= 0.9 * hybrid_host_engine_rate
                ),
                "host_allthreads_bases_per_s": round(host_mt_rate, 1),
                "host_allthreads_vs_baseline": round(
                    host_mt_rate / base_rate, 3
                ),
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
