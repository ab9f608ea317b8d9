#!/usr/bin/env python3
"""Smoke test of tpu-dagcon on an NVIDIA GPU.

    python3 chip_smoke.py             # one card, every phase below
    python3 chip_smoke.py --cards 4   # only the four-card sharded path

One card, in order (any failed phase exits non-zero):

1. environment: card name and power limit (nvidia-smi), JAX version,
   XLA_FLAGS, devices; the platform must be "gpu"; the native engine
   is built with `make` on this machine.
2. compile: the DP solvers (the scan `dp.dp_scores` and the blocked
   solve) at the devbuild and xla-path widths and the devbuild step
   (build + DP/backtrack programs), compiled for the card with
   `memory_analysis()` printed.
3. parity: the blocked solve against the scan, bitwise, on real batches
   at those widths; the one-hot (`mxu_*`) forms against NumPy, bitwise,
   at a devbuild width.
4. timings: the scan vs the blocked solve, the devbuild step's two
   programs, and each one-hot form vs its plain XLA equivalent, in
   turns in one process.
5. end to end through the CLI (in-process, `cli.main`) on BASELINE
   config #2 (512 targets x 1000 bp x 30x, seed 1234, raw 'pre'
   records, -a): `--backend devbuild` and `--backend xla` must be
   byte-identical to the 1-thread native engine, with no more host
   fallbacks than the same stream gives on the CPU; a small
   `--align-backend device` stream against the host aligner; one
   `--backend auto` stream, printing what it resolved to.
6. the tests marked `gpu`, in-process.

`--cards 4` runs four `--shard i/4 --shard-bytes --backend devbuild`
ranks, one process per card (each sees only its own card), compares
their merged output per target with the one-card run of the same
stream, then compares the column-sharded DP over the four cards with
the single-device scan.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# BASELINE.json config #2 and the flags the bench runs it with.
N_TARGETS, LENGTH, COVERAGE, SEED = 512, 1000, 30, 1234
MIN_COV, MIN_LEN = max(2, COVERAGE // 4), 100
# Host fallbacks the BASELINE #2 stream gives under JAX_PLATFORMS=cpu
# (PERF.md, "Host fallbacks"); the card may not take more.
CPU_HOST_FALLBACKS = {"devbuild": 0, "xla": 0}
ROUNDS = 3  # timing rounds, variants in turns
DEVBUILD_B = 128  # targets per devbuild step (the top B rung)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def say(*a) -> None:
    print(*a, flush=True)


def card_label() -> str:
    """`name, power limit` of the first visible card, from nvidia-smi."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0].strip()


def make_stream(n_targets: int, seed: int = SEED) -> bytes:
    from pbdagcon_tpu.simulate import (
        NoiseProfile, simulate_targets, to_pre_raw,
    )

    lines = []
    for _tid, _bb, alns in simulate_targets(
        seed, n_targets, LENGTH, COVERAGE, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    return ("\n".join(lines) + "\n").encode()


def native_reference(text: bytes) -> str:
    from pbdagcon_tpu import native

    with native.NativeEngine(
        min_weight=MIN_COV, min_length=MIN_LEN, threads=1, align=True
    ) as eng:
        return eng.consensus_text(text, fmt="pre")


def fasta_by_target(fasta: str) -> dict[str, list[str]]:
    """{target id: [header, seq, header, seq, ...]} in output order."""
    out: dict[str, list[str]] = {}
    lines = fasta.splitlines()
    for i in range(0, len(lines), 2):
        sid = lines[i][1:].rsplit("/", 1)[0]
        out.setdefault(sid, []).extend(lines[i : i + 2])
    return out


class _LogTap(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_cli(argv: list[str]) -> tuple[str, list[str], float]:
    """`cli.main(argv)` in this process: (stdout, log lines, seconds)."""
    from pbdagcon_tpu import cli

    tap = _LogTap()
    logger = logging.getLogger("pbdagcon_tpu")
    logger.addHandler(tap)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        logger.removeHandler(tap)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {argv} returned {rc}")
    return buf.getvalue(), tap.lines, dt


def log_int(lines: list[str], key: str) -> int:
    for line in reversed(lines):
        m = re.search(rf"\b{key}=(\d+)", line)
        if m:
            return int(m.group(1))
    raise SmokeError(f"no {key}= in the run's log")


# ---------------------------------------------------------------- timing
def time_in_turns(variants: dict, reps: int) -> dict[str, float]:
    """Median seconds per call of each variant; variants run in turns,
    ROUNDS rounds of `reps` calls, each call waited on, after one
    untimed call of each (compiles stay out of the window)."""
    import jax

    for fn in variants.values():
        jax.block_until_ready(fn())
    per: dict[str, list[float]] = {k: [] for k in variants}
    for _ in range(ROUNDS):
        for name, fn in variants.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                jax.block_until_ready(fn())
            per[name].append((time.perf_counter() - t0) / reps)
    return {k: sorted(v)[len(v) // 2] for k, v in per.items()}


def compile_timed(fn, *args, **kw):
    """(compiled, seconds) for a jitted function at these arguments."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn, **kw).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def mem_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    return (
        f"args={m.argument_size_in_bytes / 2**20:.1f}MiB "
        f"out={m.output_size_in_bytes / 2**20:.1f}MiB "
        f"temp={m.temp_size_in_bytes / 2**20:.1f}MiB "
        f"code={m.generated_code_size_in_bytes / 2**20:.1f}MiB"
    )


# ------------------------------------------------------------- workloads
def devbuild_batch(eng, count: int):
    """Caps and filled device inputs for the first B=128 targets of the
    encoded stream, at the rungs the adaptive pipeline settles on for
    BASELINE #2 (the bench's execute-chain derivation)."""
    import numpy as np

    from pbdagcon_tpu.devpipe import (
        DevCapsConfig, _C_LADDER, _L_LADDER, _R_LADDER, _ladder, caps_for,
        ins_cap,
    )

    metas = eng.enc_metas(count)
    prof = (
        DevCapsConfig.compact()
        if int(metas[:, 3].sum()) <= 0.11 * max(1, int(metas[:, 4].sum()))
        else DevCapsConfig.heavy()
    )
    caps = caps_for(
        DEVBUILD_B,
        _ladder(int(metas[:, 0].max()), _R_LADDER),
        _ladder(int(metas[:, 1].max()), _C_LADDER),
        _ladder(int(metas[:, 2].max()), _L_LADDER),
        prof,
        ch_need=int(metas[:, 5].max()), sm_need=int(metas[:, 6].max()),
        nd_need=int(metas[:, 3].max()), dq_need=int(metas[:, 7].max()),
        se_need=int(metas[:, 8].max()), w_need=64,
    )
    ni = ins_cap(caps)
    part = [i for i in range(count) if int(metas[i, 3]) <= ni][: caps.B]
    from pbdagcon_tpu.devpipe import _PACK_OPS

    fill = eng.enc_fill_packed if _PACK_OPS else eng.enc_fill
    arrs = fill(part, caps.R, caps.C, caps.L, ni, B=caps.B)
    return caps, tuple(np.asarray(a) for a in arrs)


def xla_batches(eng, count: int):
    """{W: packed [512, V, W] DP batch} from the linearized stream, at
    the bench's single V bucket (1.3 x the largest node count, rounded
    up to 256) and, per W, the smallest K rung covering its long edges
    (targets over K=128 drop)."""
    metas = eng.metas(count)
    V = -(-int(1.3 * int(metas[:, 0].max())) // 256) * 256
    idxs = list(range(min(count, 512)))
    out = {}
    for W in (16, 32, 64):
        longs = {i: int(eng.long_counts(i, (W,))[0]) for i in idxs}
        keep = [i for i in idxs if longs[i] <= 128]
        K = next(k for k in (8, 32, 128) if k >= max(longs[i] for i in keep))
        out[W] = eng.pack_batch(keep, V, W, K, b_pad=512)
    return out


# ---------------------------------------------------------------- phases
def phase_dp(card: str, eng_lin, count_lin, build_out) -> None:
    """Phases 2-4 for the DP: compile, parity, timing."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbdagcon_tpu.devpipe import BUILD_DP_KEYS
    from pbdagcon_tpu.ops.dp import DP_KEYS, _blocked_L, dp_scores
    from pbdagcon_tpu.ops.dp_blocked import dp_scores_blocked

    shapes = {"devbuild": tuple(build_out[k] for k in BUILD_DP_KEYS)}
    for W, b in xla_batches(eng_lin, count_lin).items():
        shapes[f"xla-W{W}"] = tuple(jnp.asarray(b[k]) for k in DP_KEYS)

    for name, args in shapes.items():
        B, V, W = args[0].shape
        K = args[4].shape[1]
        L = _blocked_L(V)
        # compile each solver once, timed, with its memory use
        scan_fn = jax.jit(dp_scores)
        blk_fn = jax.jit(lambda *a: dp_scores_blocked(*a, L=L))
        compiled = {}
        for sname, fn in (("scan", scan_fn), ("blocked", blk_fn)):
            c, dt = compile_timed(fn, *args)
            compiled[sname] = c
            say(
                f"compile dp {name} [B={B} V={V} W={W} K={K}] "
                f"{sname}: {dt:.2f}s {mem_line(c)}"
            )
        ref = np.asarray(compiled["scan"](*args))
        check(np.isfinite(ref[:, 0]).any(), f"no finite DP score at {name}")
        bs, unconv = (np.asarray(x) for x in compiled["blocked"](*args))
        conv = ~unconv
        check(
            np.array_equal(bs[conv], ref[conv]),
            f"blocked != dp_scores on converged rows at {name}",
        )
        say(
            f"parity dp {name}: blocked == scan bitwise on "
            f"{int(conv.sum())}/{B} converged rows"
        )
        t = time_in_turns(
            {k: (lambda c=c: c(*args)) for k, c in compiled.items()},
            reps=5,
        )
        say(
            f"time dp {name} [B={B} V={V} W={W} K={K}] ({card}): "
            + " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in t.items())
        )


def phase_onehot(card: str, caps) -> None:
    """Phases 2-4 for the one-hot forms at a devbuild width: bitwise
    against NumPy, then timed against the plain XLA equivalent."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pbdagcon_tpu.ops import mxu

    rng = np.random.default_rng(SEED)
    B = caps.B
    N = caps.R * caps.C  # event / column axis of the transition build
    T = caps.V  # node-indexed tables (emit, band assembly)
    D = (caps.L + 2) * (caps.DQ + 3)  # transition key grid
    NC = caps.NC  # chain table (rank scatters)
    rows = np.arange(B)[:, None]

    vals = rng.integers(0, D, (B, N)).astype(np.int32)
    valid = rng.random((B, N)) < 0.7
    tbl = rng.integers(0, 1 << 15, (B, T)).astype(np.int32)
    idx = rng.integers(0, T, (B, T)).astype(np.int32)
    # plane transport: p-space tables (width L + 2) read at v-space
    TP = caps.L + 2
    ptbl = rng.integers(0, 1 << 16, (B, TP)).astype(np.int32)
    ptbl2 = rng.integers(0, 1 << 8, (B, TP)).astype(np.int32)
    pidx = rng.integers(0, TP, (B, T)).astype(np.int32)
    perm = np.stack([rng.permutation(NC) for _ in range(B)]).astype(np.int32)
    pay = rng.integers(0, 1 << 16, (B, NC)).astype(np.int32)
    ref_hist = np.zeros((B, D), np.int64)
    np.add.at(ref_hist, (np.broadcast_to(rows, (B, N))[valid], vals[valid]), 1)
    ref_gather = np.take_along_axis(tbl, idx, -1)
    ref_p1 = np.take_along_axis(ptbl, pidx, -1)
    ref_p2 = np.take_along_axis(ptbl2, pidx, -1)
    ref_scatter = np.zeros((B, NC), np.int64)
    np.put_along_axis(ref_scatter, perm, pay, -1)
    J = {k: jnp.asarray(v) for k, v in dict(
        vals=vals, valid=valid, tbl=tbl, idx=idx, ptbl=ptbl,
        ptbl2=ptbl2, pidx=pidx, perm=perm, pay=pay,
    ).items()}
    brow = jnp.arange(B)[:, None]

    forms = {
        "hist": (
            jax.jit(lambda v, m: mxu.mxu_hist(v, m, D)),
            jax.jit(lambda v, m: jnp.zeros((B, D), jnp.int32).at[
                brow, jnp.where(m, v, D)].add(1, mode="drop")),
            (J["vals"], J["valid"]), ref_hist,
        ),
        "gather": (
            jax.jit(lambda t, i: mxu.mxu_gather(t, i, max_val=1 << 15)),
            jax.jit(lambda t, i: jnp.take_along_axis(t, i, -1)),
            (J["tbl"], J["idx"]), ref_gather,
        ),
        "gather_planes": (
            jax.jit(lambda t, t2, i: mxu.mxu_gather_planes(
                [(t, 2), (t2, 1)], i)),
            jax.jit(lambda t, t2, i: [
                jnp.take_along_axis(t, i, -1),
                jnp.take_along_axis(t2, i, -1)]),
            (J["ptbl"], J["ptbl2"], J["pidx"]), [ref_p1, ref_p2],
        ),
        "scatter": (
            jax.jit(lambda r, p: mxu.mxu_scatter(
                r, jnp.ones(r.shape, bool), (p,), NC)[0]),
            jax.jit(lambda r, p: jnp.zeros((B, NC), jnp.int32).at[
                brow, r].set(p, unique_indices=True)),
            (J["perm"], J["pay"]), ref_scatter,
        ),
    }
    for name, (onehot, plain, args, ref) in forms.items():
        refs = ref if isinstance(ref, list) else [ref]
        for label, fn in (("onehot", onehot), ("plain", plain)):
            c, dt = compile_timed(fn, *args)
            out = c(*args)
            outs = out if isinstance(out, (list, tuple)) else [out]
            for o, r in zip(outs, refs):
                check(
                    np.array_equal(np.asarray(o), r),
                    f"{name} {label} != NumPy",
                )
            say(f"compile {name} {label}: {dt:.2f}s {mem_line(c)}")
        t = time_in_turns(
            {"onehot": lambda: onehot(*args), "plain": lambda: plain(*args)},
            reps=10,
        )
        say(
            f"time onehot-vs-plain {name} [B={B} N={args[-1].shape[1]}] "
            f"({card}): onehot={t['onehot'] * 1e3:.3f}ms "
            f"plain={t['plain'] * 1e3:.3f}ms (both == NumPy bitwise)"
        )


def phase_devbuild_step(card: str, caps, dev_in):
    """Compile the devbuild step at bench caps (memory printed), run it
    once, time it; returns the build outputs for the DP phases."""
    import jax
    import jax.numpy as jnp

    from pbdagcon_tpu.devpipe import dp_route, step_programs

    P = min(caps.V, 2 * caps.L + 64)
    build, dp_emit = step_programs(caps, P)
    t0 = time.perf_counter()
    cb = build.func.lower(*dev_in, caps=caps).compile()
    say(
        f"compile devbuild build program {caps}: "
        f"{time.perf_counter() - t0:.2f}s {mem_line(cb)}"
    )
    out = build(*dev_in)
    mw = jnp.int32(MIN_COV)
    t0 = time.perf_counter()
    ce = dp_emit.lower(out, mw).compile()
    say(
        f"compile devbuild dp+emit program (dp route "
        f"{dp_route(caps)}): {time.perf_counter() - t0:.2f}s {mem_line(ce)}"
    )
    t = time_in_turns(
        {
            "build": lambda: build(*dev_in),
            "dp_emit": lambda: dp_emit(out, mw),
        },
        reps=3,
    )
    say(
        f"time devbuild step [B={caps.B} V={caps.V} W={caps.W}] ({card}): "
        f"build={t['build'] * 1e3:.2f}ms dp_emit={t['dp_emit'] * 1e3:.2f}ms"
    )
    jax.block_until_ready(out)
    return out


def phase_e2e(text: bytes, ref: str, work: str) -> None:
    path = os.path.join(work, "baseline2.pre")
    with open(path, "wb") as f:
        f.write(text)
    common = [path, "-c", str(MIN_COV), "-m", str(MIN_LEN), "-a",
              "--fmt", "pre"]
    for backend in ("devbuild", "xla"):
        for attempt in ("cold", "warm"):
            fa, logs, dt = run_cli(common + ["--backend", backend])
            check(fa == ref, f"--backend {backend} FASTA != native 1-thread")
            fb = log_int(logs, "host_fallbacks")
            targets = log_int(logs, "targets")
            say(
                f"e2e --backend {backend} ({attempt}): {dt:.2f}s "
                f"targets={targets} host_fallbacks={fb} "
                f"FASTA == native 1-thread ({len(fa)} bytes)"
            )
            check(
                fb <= CPU_HOST_FALLBACKS[backend],
                f"--backend {backend}: {fb} host fallbacks > "
                f"{CPU_HOST_FALLBACKS[backend]} on the CPU",
            )

    small = make_stream(16, seed=SEED + 1)
    spath = os.path.join(work, "small.pre")
    with open(spath, "wb") as f:
        f.write(small)
    fa, _logs, dt = run_cli(
        [spath, "-c", str(MIN_COV), "-m", str(MIN_LEN), "-a", "--fmt",
         "pre", "--backend", "xla", "--align-backend", "device"]
    )
    check(fa == native_reference(small), "device aligner != host aligner")
    say(f"e2e --align-backend device (16 targets): {dt:.2f}s == host aligner")

    fa, logs, dt = run_cli(common + ["--backend", "auto"])
    check(fa == ref, "--backend auto FASTA != native 1-thread")
    resolved = next(
        (
            l.rsplit(" ", 1)[1] for l in logs
            if l.startswith("backend: auto resolved to ")
        ),
        "?",
    )
    dev_chunks = (
        log_int(logs, "dev_chunks") if resolved == "hybrid" else None
    )
    say(
        f"e2e --backend auto: {dt:.2f}s resolved to {resolved}, device "
        f"chunks={dev_chunks} (not counted as the card having worked)"
    )


def phase_tests() -> None:
    import pytest

    os.environ["DAGCON_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests")]
    )
    check(rc == 0, f"gpu-marked tests failed (pytest rc={rc})")


def env_phase(card: str) -> None:
    import jax

    say(card)  # nvidia-smi name, power.limit as printed
    say(f"jax {jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say(f"devices: {jax.devices()}")
    check(
        jax.devices()[0].platform == "gpu",
        f"platform is {jax.devices()[0].platform!r}, not 'gpu'",
    )


def build_native() -> None:
    from pbdagcon_tpu import native

    t0 = time.perf_counter()
    check(native.ensure_built(), "native engine failed to build (make)")
    say(f"native engine built with make in {time.perf_counter() - t0:.1f}s")


def one_card(work: str) -> None:
    import jax

    from pbdagcon_tpu import native
    from pbdagcon_tpu.config import enable_compile_cache

    card = card_label()
    env_phase(card)
    build_native()
    enable_compile_cache()

    t0 = time.perf_counter()
    text = make_stream(N_TARGETS)
    ref = native_reference(text)
    say(
        f"workload: {N_TARGETS} targets x {LENGTH} bp x {COVERAGE}x "
        f"({len(text) / 1e6:.1f} MB), native 1-thread reference in "
        f"{time.perf_counter() - t0:.1f}s"
    )

    with native.NativeEngine(
        min_weight=MIN_COV, min_length=MIN_LEN, threads=os.cpu_count() or 4,
        align=True,
    ) as eng:
        count = eng.encode_text(text, fmt="pre", flush=True)
        caps, arrs = devbuild_batch(eng, count)
    dev_in = tuple(jax.device_put(a) for a in arrs)
    build_out = phase_devbuild_step(card, caps, dev_in)
    with native.NativeEngine(
        min_weight=MIN_COV, min_length=MIN_LEN, threads=os.cpu_count() or 4,
        align=True,
    ) as eng:
        count = eng.linearize_text(text, fmt="pre")
        phase_dp(card, eng, count, build_out)
    del build_out
    phase_onehot(card, caps)
    phase_e2e(text, ref, work)
    phase_tests()


def four_cards(work: str) -> None:
    """Sharded devbuild over four cards (one process each) vs the
    one-card run; column-sharded DP over four devices vs the scan."""
    card = card_label()
    say(card)  # nvidia-smi name, power.limit as printed
    build_native()
    text = make_stream(N_TARGETS)
    path = os.path.join(work, "baseline2.pre")
    with open(path, "wb") as f:
        f.write(text)
    argv = [path, "-c", str(MIN_COV), "-m", str(MIN_LEN), "-a", "--fmt",
            "pre", "--backend", "devbuild"]
    procs = []
    t0 = time.perf_counter()
    try:
        for i in range(4):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(i))
            out = open(os.path.join(work, f"rank{i}.fa"), "wb")
            err = open(os.path.join(work, f"rank{i}.log"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "pbdagcon_tpu", *argv,
                 "--shard", f"{i}/4", "--shard-bytes"],
                stdout=out, stderr=err, env=env, cwd=ROOT,
            ), out, err))
        for i, (p, out, err) in enumerate(procs):
            rc = p.wait(timeout=900)
            out.close()
            err.close()
            if rc != 0:
                with open(os.path.join(work, f"rank{i}.log")) as f:
                    sys.stderr.write(f.read()[-4000:])
            check(rc == 0, f"rank {i} exited {rc}")
    finally:
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
    say(f"4 ranks (one card each) done in {time.perf_counter() - t0:.2f}s")
    merged: dict[str, list[str]] = {}
    for i in range(4):
        with open(os.path.join(work, f"rank{i}.fa")) as f:
            part = fasta_by_target(f.read())
        check(not (merged.keys() & part.keys()), "ranks overlap")
        merged.update(part)

    # JAX starts in this process only now: the ranks held the cards.
    import jax
    import numpy as np

    from pbdagcon_tpu import native
    from pbdagcon_tpu.config import enable_compile_cache

    say(f"devices: {jax.devices()}")
    check(jax.devices()[0].platform == "gpu", "platform is not 'gpu'")
    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, not 4")
    enable_compile_cache()
    fa, _logs, dt = run_cli(argv)
    one = fasta_by_target(fa)
    check(merged == one, "4-rank merged output != one-card run per target")
    say(
        f"sharded devbuild: {len(merged)} targets over 4 ranks == one-card "
        f"run per target (one-card {dt:.2f}s)"
    )

    from pbdagcon_tpu.config import DagconConfig
    from pbdagcon_tpu.ops.dp import DP_KEYS, dp_scores, pad_batch
    from pbdagcon_tpu.pipeline import _colshard_oversize

    # One oversized target (past the top V bucket): a 16 kb backbone at
    # 8x, whose edges all fit the band (colshard carries no long edges).
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_m5

    lines = []
    for _t, _bb, alns in simulate_targets(SEED, 1, 16000, 8,
                                          NoiseProfile()):
        lines.extend(to_m5(a) for a in alns)
    cfg = DagconConfig(min_weight=MIN_COV, min_length=MIN_LEN)
    with native.NativeEngine(min_weight=MIN_COV, min_length=MIN_LEN,
                             threads=os.cpu_count() or 4) as eng:
        cnt = eng.linearize_text(("\n".join(lines) + "\n").encode())
        check(cnt == 1, "long target did not linearize")
        n = int(eng.metas(1)[0, 0])
        t0 = time.perf_counter()
        cs = _colshard_oversize(eng, 0, n, cfg)
        dt = time.perf_counter() - t0
        check(cs is not None, "colshard path declined the long target")
        lin = eng.get_linear(0)
        W = next(w for w in cfg.w_buckets if lin.span <= w)
        b = pad_batch([lin], -(-n // 256) * 256, W, K=1)
        ref = np.asarray(dp_scores(*(b[k] for k in DP_KEYS)))[0, :n]
    check(np.array_equal(cs[:n], ref), "colsharded_scores != dp_scores")
    say(
        f"colshard: n={n} W={W} over 4 devices ({dt:.2f}s) == "
        f"single-device dp_scores bitwise ({card})"
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--cards", type=int, choices=(1, 4), default=1,
        help="4: run only the sharded four-card path and its comparison",
    )
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    work = tempfile.mkdtemp(prefix="dagcon-smoke-")
    try:
        if args.cards == 4:
            four_cards(work)
        else:
            one_card(work)
    except SmokeError as e:
        print(f"SMOKE FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
