"""`tpu-dagcon` CLI, mirroring the reference `dagcon` flags.

Reference flags (reconstructed from `src/cpp/main.cpp`, SURVEY.md §2 C6;
mount empty): positional M5 input (or stdin), `-c` min coverage (8),
`-m` min length (500), `-j` threads (4), `-t` trim (0). Names and
defaults preserved for behavioural comparison; accelerator knobs are
additive.
"""

from __future__ import annotations

import argparse
import logging
import sys

from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter, open_input
from pbdagcon_tpu.pipeline import run_stream


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-dagcon",
        description=(
            "Accelerator DAG consensus with pbdagcon's capabilities: "
            "M5/'pre' alignments in, consensus FASTA out."
        ),
    )
    p.add_argument(
        "input",
        nargs="?",
        default="-",
        help="M5/'pre' alignment file, target-sorted ('-' = stdin)",
    )
    p.add_argument(
        "-c",
        "--min-coverage",
        type=int,
        default=8,
        help="minimum coverage (node weight) to keep a consensus base",
    )
    p.add_argument(
        "-m",
        "--min-length",
        type=int,
        default=500,
        help="minimum consensus fragment length to emit",
    )
    p.add_argument(
        "-t", "--trim", type=int, default=0,
        help="trim N aligned query bases off both alignment ends",
    )
    p.add_argument(
        "-a", "--align", action="store_true",
        help="re-align raw (ungapped) seq pairs before consensus "
        "(for 'pre' records carrying unaligned sequences)",
    )
    p.add_argument(
        "-j", "--threads", type=int, default=4,
        help="host worker threads (native graph build)",
    )
    p.add_argument(
        "--fmt", choices=("m5", "pre"), default="m5", help="input format"
    )
    p.add_argument(
        "--backend",
        choices=(
            "auto", "xla", "blocked", "host", "devbuild",
            "hybrid",
        ),
        default="auto",
        help="consensus backend (devbuild = graph build + merge + DP + "
        "backtrack all on device)",
    )
    p.add_argument(
        "--align-backend",
        choices=("host", "device"),
        default="host",
        help="where -a re-alignment runs: threaded C++ banded DP (host) "
        "or the batched device kernel (device); both are exact",
    )
    p.add_argument(
        "--align-scorer",
        choices=("simple", "affine"),
        default="simple",
        help="-a scoring scheme: linear-gap 1/-2/-3 (simple, default) "
        "or affine Gotoh (SPEC §1.6); see docs/SCORER_SENSITIVITY.md",
    )
    p.add_argument(
        "--affine-params",
        default="1,-2,-4,-1",
        metavar="M,X,O,E",
        help="affine scorer parameters match,mismatch,open,extend "
        "(gap of length k scores open+(k-1)*extend)",
    )
    p.add_argument(
        "--batch-targets", type=int, default=128,
        help="max targets per device batch",
    )
    p.add_argument(
        "--transfer-cap-mb", type=int, default=0,
        help="cap per host->device transfer (MB); 0 = 1 GiB",
    )
    p.add_argument(
        "--chunk-mb", type=int, default=16,
        help="streaming feed-chunk size (MB); DAGCON_CHUNK_MB overrides",
    )
    p.add_argument(
        "--edge-upload", action="store_true",
        help="upload graph batches as edge-CSR streams (~10x less "
        "transfer; the dense band is rebuilt on device)",
    )
    p.add_argument(
        "--width", type=int, default=0,
        help="FASTA line width (0 = unwrapped)",
    )
    p.add_argument(
        "--shard", default=None, metavar="I/N",
        help="process only target-groups i mod N == I (multi-host "
        "manifest sharding; each host writes its own output)",
    )
    p.add_argument(
        "--shard-bytes", action="store_true",
        help="with --shard/--distributed and a file input: each rank "
        "reads only its own byte range of the file (group-boundary "
        "exact) instead of parsing the whole stream and filtering — "
        "removes the parse-replication scaling floor",
    )
    p.add_argument(
        "--journal", default=None, metavar="PATH",
        help="completed-target journal: skip targets already recorded, "
        "append as they finish (restart-safe streaming)",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="write a jax.profiler trace of the run to DIR",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="multi-host pod run: jax.distributed.initialize() (reads "
        "the standard coordinator env vars) and default --shard to "
        "process_index/process_count; each host writes its own output",
    )
    p.add_argument(
        "--selfcheck", action="store_true",
        help="debug: per target, assert graph invariants (no dangling "
        "nodes — the reference danglingNodes() check) and that the "
        "linearized DP reproduces the graph-walk consensus; slower "
        "(Python oracle), output unchanged",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    cfg = DagconConfig(
        min_weight=args.min_coverage,
        min_length=args.min_length,
        threads=args.threads,
        trim=args.trim,
        align=args.align,
        align_backend=args.align_backend,
        align_scorer=args.align_scorer,
        affine_params=tuple(
            int(x) for x in args.affine_params.split(",")
        ),
        fmt=args.fmt,
        backend=args.backend,
        batch_targets=args.batch_targets,
        transfer_cap_bytes=args.transfer_cap_mb << 20,
        chunk_mb=args.chunk_mb,
        edge_upload=args.edge_upload,
    )
    stream = open_input(args.input)

    if args.distributed:
        import os as _os

        import jax

        # Cluster environments auto-detect; standalone runs (and the CPU
        # multi-process simulation in tests) pass the standard
        # coordinator variables explicitly.
        kw = {}
        if _os.environ.get("JAX_COORDINATOR_ADDRESS"):
            kw["coordinator_address"] = _os.environ[
                "JAX_COORDINATOR_ADDRESS"
            ]
        if _os.environ.get("JAX_NUM_PROCESSES"):
            kw["num_processes"] = int(_os.environ["JAX_NUM_PROCESSES"])
        if _os.environ.get("JAX_PROCESS_ID"):
            kw["process_id"] = int(_os.environ["JAX_PROCESS_ID"])
        jax.distributed.initialize(**kw)
        if not args.shard:
            args.shard = f"{jax.process_index()}/{jax.process_count()}"
        if args.backend == "host":
            # The host backend is shared-nothing after the shard split:
            # no collectives, no global device mesh. Detach from the
            # coordination service once every rank has its rank/count,
            # so a peer's death (kill/restart, preemption) cannot
            # propagate — measured: with the service attached, the
            # heartbeat monitor TERMINATES surviving ranks when one
            # rank is SIGKILLed (tools/soak_multirank.py finding).
            try:
                from jax._src import distributed as _dist

                client = _dist.global_state.client
                if client is not None:
                    # barrier first: rank 0 hosts the service, so it
                    # must not tear it down before peers connect.
                    client.wait_at_barrier("dagcon_detach", 30_000)
            except Exception:  # pragma: no cover - private API drift
                import time as _time

                _time.sleep(2.0)
            try:
                jax.distributed.shutdown()
            except Exception:  # pragma: no cover - peer raced teardown
                # Rank 0 may tear the service down between our barrier
                # return and this call (or the barrier fell back to the
                # sleep above on API drift). Detaching is best-effort:
                # a failed shutdown must never kill a surviving rank.
                logging.getLogger("pbdagcon_tpu").warning(
                    "distributed: shutdown raised; continuing detached",
                    exc_info=True,
                )
            logging.getLogger("pbdagcon_tpu").info(
                "distributed: detached after shard assignment "
                "(host backend, shared-nothing)"
            )

    journal = None
    if args.journal:
        from pbdagcon_tpu.parallel.journal import TargetJournal

        journal = TargetJournal(
            args.journal, before_flush=sys.stdout.flush
        )

    if args.shard or journal is not None:
        from pbdagcon_tpu.io import filter_groups_text

        shard_i, shard_n = 0, 1
        if args.shard:
            shard_i, shard_n = (int(x) for x in args.shard.split("/"))

        if (
            args.shard_bytes
            and args.shard
            and args.input not in (None, "-")
        ):
            # Byte-range sharding: this rank parses only ~1/N of the
            # file (group-boundary exact; io.shard_stream_bytes).
            from pbdagcon_tpu.io import shard_stream_bytes

            stream.close()
            stream = shard_stream_bytes(
                args.input, cfg.fmt, shard_i, shard_n
            )
            if journal is not None:
                stream = filter_groups_text(
                    stream, cfg.fmt,
                    lambda sid, _g: sid not in journal,
                )
        else:
            if args.shard_bytes:
                logging.getLogger("pbdagcon_tpu").warning(
                    "--shard-bytes needs --shard/--distributed and a "
                    "file input; falling back to filtered streaming"
                )

            def keep(sid: str, gidx: int) -> bool:
                if gidx % shard_n != shard_i:
                    return False
                return journal is None or sid not in journal

            stream = filter_groups_text(stream, cfg.fmt, keep)

    if args.selfcheck:
        from pbdagcon_tpu.selfcheck import run_selfcheck

        rc = run_selfcheck(stream, cfg)
        if journal is not None:
            journal.close()
        return rc

    writer = FastaWriter(sys.stdout, width=args.width)

    profiler_cm = None
    if args.profile_dir:
        import jax

        profiler_cm = jax.profiler.trace(args.profile_dir)
        profiler_cm.__enter__()
    import time as _time

    _t0 = _time.time()
    try:
        run_stream(stream, writer, cfg, journal=journal)
        import resource as _res

        _ru = _res.getrusage(_res.RUSAGE_SELF)
        # cpu_time next to wall time lets multi-process forensics tell
        # core contention (cpu ~= wall * threads) from serialization
        # (cpu << wall) per rank.
        print(
            f"proc_time={_time.time() - _t0:.3f}s "
            f"cpu_time={_ru.ru_utime + _ru.ru_stime:.3f}s",
            file=sys.stderr,
        )
    finally:
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
        if journal is not None:
            journal.close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
