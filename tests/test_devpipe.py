"""End-to-end tests for the all-on-device pipeline (backend=devbuild):
byte parity with the host path over the CLI surface."""

import io as _io
import random

from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream
from pbdagcon_tpu.simulate import (
    NoiseProfile,
    simulate_targets,
    to_m5,
    to_pre,
)


def _run(text: str, backend: str, **kw) -> tuple[str, object]:
    buf = _io.StringIO()
    cfg = DagconConfig(backend=backend, use_native=False, **kw)
    stats = run_stream(_io.StringIO(text), FastaWriter(buf), cfg)
    return buf.getvalue(), stats


def test_devbuild_matches_host_m5():
    lines = []
    rng = random.Random(31337)
    for tid, _bb, alns in simulate_targets(77, 6, 300, 12):
        for a in alns:
            lines.append(to_m5(a, flip=rng.random() < 0.3))
    text = "\n".join(lines) + "\n"
    host, _ = _run(text, "host", min_weight=3, min_length=50)
    dev, stats = _run(text, "devbuild", min_weight=3, min_length=50)
    assert dev == host
    assert stats.targets == 6
    assert stats.batches >= 1


def test_devbuild_matches_host_pre_gappy():
    lines = []
    for tid, _bb, alns in simulate_targets(
        55, 4, 150, 8, NoiseProfile(sub=0.05, ins=0.2, dele=0.1)
    ):
        for a in alns:
            lines.append(to_pre(a))
    text = "\n".join(lines) + "\n"
    host, _ = _run(text, "host", fmt="pre", min_weight=2, min_length=20)
    dev, stats = _run(
        text, "devbuild", fmt="pre", min_weight=2, min_length=20
    )
    assert dev == host


def test_devbuild_with_trim_and_fallbacks():
    lines = []
    for tid, _bb, alns in simulate_targets(91, 3, 500, 25):
        for a in alns:
            lines.append(to_m5(a))
    text = "\n".join(lines) + "\n"
    host, _ = _run(text, "host", min_weight=4, min_length=100, trim=2)
    dev, stats = _run(
        text, "devbuild", min_weight=4, min_length=100, trim=2
    )
    assert dev == host


def test_devbuild_native_streaming_matches_host():
    """Native encoder + device build + device backtrack == native host
    engine, over the streaming entry (m5 + align-mode pre)."""
    import pytest

    from pbdagcon_tpu import native

    if not native.available():
        pytest.skip("native library not built")
    lines = []
    rng = random.Random(11)
    for tid, _bb, alns in simulate_targets(42, 5, 400, 18):
        for a in alns:
            lines.append(to_m5(a, flip=rng.random() < 0.25))
    text = "\n".join(lines) + "\n"
    buf_h = _io.StringIO()
    run_stream(
        _io.StringIO(text), FastaWriter(buf_h),
        DagconConfig(backend="host", use_native=True, min_weight=3,
                     min_length=60),
    )
    buf_d = _io.StringIO()
    stats = run_stream(
        _io.StringIO(text), FastaWriter(buf_d),
        DagconConfig(backend="devbuild", use_native=True, min_weight=3,
                     min_length=60),
    )
    assert buf_d.getvalue() == buf_h.getvalue()
    assert stats.targets == 5


def test_devbuild_native_align_mode():
    import pytest

    from pbdagcon_tpu import native
    from pbdagcon_tpu.simulate import to_pre_raw

    if not native.available():
        pytest.skip("native library not built")
    lines = []
    for tid, _bb, alns in simulate_targets(17, 3, 250, 10):
        for a in alns:
            lines.append(to_pre_raw(a))
    text = "\n".join(lines) + "\n"
    buf_h = _io.StringIO()
    run_stream(
        _io.StringIO(text), FastaWriter(buf_h),
        DagconConfig(backend="host", use_native=True, fmt="pre",
                     align=True, min_weight=2, min_length=50),
    )
    buf_d = _io.StringIO()
    run_stream(
        _io.StringIO(text), FastaWriter(buf_d),
        DagconConfig(backend="devbuild", use_native=True, fmt="pre",
                     align=True, min_weight=2, min_length=50),
    )
    assert buf_d.getvalue() == buf_h.getvalue()


def test_native_meta_needs_match_python_chain_stats():
    """meta[5:9] (CH/SM/DQ/SE needs) from the C++ encoder must equal the
    Python-path mirror (devpipe.chain_stats) on the same groups."""
    import numpy as np
    import pytest

    from pbdagcon_tpu import native
    from pbdagcon_tpu.devpipe import chain_stats
    from pbdagcon_tpu.ops.devbuild import encode_group
    from pbdagcon_tpu.simulate import NoiseProfile, to_pre_raw

    if not native.available():
        pytest.skip("native library not built")
    lines = []
    groups = []
    profs = [
        NoiseProfile(),
        NoiseProfile(sub=0.05, ins=0.2, dele=0.1),
        NoiseProfile(sub=0.02, ins=0.3, dele=0.15, max_ins_run=5),
    ]
    for i, (tid, bb, alns) in enumerate(
        simulate_targets(99, 6, 200, 12)
    ):
        groups.append((bb, alns))
        for a in alns:
            lines.append(to_pre_raw(a))
    text = ("\n".join(lines) + "\n").encode()
    with native.NativeEngine(
        min_weight=2, min_length=50, threads=2, align=True
    ) as eng:
        count = eng.encode_text(text, fmt="pre", flush=True)
        assert count == len(groups)
        metas = eng.enc_metas(count)
    # Python mirror: same text through the Python parser + aligner, so
    # both sides encode identical alignments.
    from pbdagcon_tpu.aligner import align_record
    from pbdagcon_tpu.io import read_groups

    pygroups = list(
        read_groups(_io.StringIO(text.decode()), fmt="pre")
    )
    assert len(pygroups) == count
    for i, g in enumerate(pygroups):
        realigned = [align_record(a) for a in g.alns]
        enc = encode_group(g.backbone, realigned, sid=g.sid)
        ch, sm, dq, se = chain_stats(enc.ops, enc.starts)
        assert tuple(metas[i, 5:9]) == (ch, sm, dq, se), f"target {i}"


def test_enc_fill_packed_matches_unpacked():
    """The 2-bit-packed fill must carry exactly the bytes of the plain
    fill: unpacking [B, R, C//4] on the host AND through the jitted
    unpack_ops both reproduce the plain ops array; every other output
    array is byte-identical."""
    import numpy as np
    import pytest

    from pbdagcon_tpu import native
    from pbdagcon_tpu.ops.devbuild_jax import unpack_ops
    from pbdagcon_tpu.simulate import to_pre_raw

    if not native.available():
        pytest.skip("native library not built")
    lines = []
    n_targets = 0
    for tid, bb, alns in simulate_targets(7, 5, 240, 10):
        n_targets += 1
        for a in alns:
            lines.append(to_pre_raw(a))
    text = ("\n".join(lines) + "\n").encode()
    with native.NativeEngine(
        min_weight=2, min_length=50, threads=2, align=True
    ) as eng:
        count = eng.encode_text(text, fmt="pre", flush=True)
        assert count == n_targets
        metas = eng.enc_metas(count)
        R = int(metas[:, 0].max())
        C = (int(metas[:, 1].max()) + 3) // 4 * 4
        L = int(metas[:, 2].max())
        NI = int(metas[:, 3].max())
        idxs = list(range(count))
        ops, starts, bb_, ins, Lr = eng.enc_fill(idxs, R, C, L, NI)
        opsp, starts2, bb2, ins2, Lr2 = eng.enc_fill_packed(
            idxs, R, C, L, NI
        )
    assert opsp.shape == (count, R, C // 4)
    # Host unpack (bit-for-bit the wire format).
    host_unpacked = np.zeros_like(ops)
    for j in range(4):
        host_unpacked[:, :, j::4] = (opsp >> (2 * j)) & 3
    np.testing.assert_array_equal(host_unpacked, ops)
    # Device unpack helper.
    np.testing.assert_array_equal(np.asarray(unpack_ops(opsp)), ops)
    np.testing.assert_array_equal(starts2, starts)
    np.testing.assert_array_equal(bb2, bb_)
    np.testing.assert_array_equal(ins2, ins)
    np.testing.assert_array_equal(Lr2, Lr)


def test_devbuild_native_multi_window_streaming():
    """The three-stage threaded devbuild pipeline must keep engine
    indices aligned across >1 emission window (submit offsets shift as
    earlier windows clear) and preserve input order, including repeated
    non-consecutive sids and flagged/fallback targets interleaved."""
    import pytest

    from pbdagcon_tpu import native

    if not native.available():
        pytest.skip("native library not built")
    lines = []
    rng = random.Random(5)
    groups = list(simulate_targets(77, 23, 300, 10))
    # repeat an earlier target id later in the stream (distinct group)
    tid0, bb0, alns0 = groups[3]
    groups.append((tid0, bb0, alns0))
    for _tid, _bb, alns in groups:
        for a in alns:
            lines.append(to_m5(a, flip=rng.random() < 0.3))
    text = "\n".join(lines) + "\n"
    cfg_kw = dict(use_native=True, min_weight=3, min_length=50)
    buf_h = _io.StringIO()
    run_stream(
        _io.StringIO(text), FastaWriter(buf_h),
        DagconConfig(backend="host", **cfg_kw),
    )
    # batch_targets=8 forces 3 windows of 8 targets over 24 groups.
    buf_d = _io.StringIO()
    stats = run_stream(
        _io.StringIO(text), FastaWriter(buf_d),
        DagconConfig(backend="devbuild", batch_targets=8, **cfg_kw),
    )
    assert buf_d.getvalue() == buf_h.getvalue()
    assert stats.targets == 24


def test_xla_native_ladder_boundary_counts():
    """Dispatch decomposition pads tails up one ladder rung and takes
    full rungs greedily; a target count straddling rungs (e.g. 19) must
    still emit every target once, in order, byte-equal to host."""
    import pytest

    from pbdagcon_tpu import native

    if not native.available():
        pytest.skip("native library not built")
    lines = []
    for _tid, _bb, alns in simulate_targets(9, 19, 300, 10):
        lines.extend(to_m5(a) for a in alns)
    text = "\n".join(lines) + "\n"
    cfg_kw = dict(use_native=True, min_weight=3, min_length=50)
    buf_h = _io.StringIO()
    run_stream(
        _io.StringIO(text), FastaWriter(buf_h),
        DagconConfig(backend="host", **cfg_kw),
    )
    buf_d = _io.StringIO()
    stats = run_stream(
        _io.StringIO(text), FastaWriter(buf_d),
        DagconConfig(backend="xla", batch_targets=16, **cfg_kw),
    )
    assert buf_d.getvalue() == buf_h.getvalue()
    assert stats.targets == 19


def test_caps_convergence_random_class_mix():
    """Property test for the window scheduler's caps adaptation
    (VERDICT r3 #8): over a random mix of workload classes, each
    bucket's caps choice must converge — a bounded number of distinct
    compiled caps per class, no flip-flop after warmup — and targets
    that exceed the chosen NI must be excluded (flag-and-fallback),
    never batched."""
    import numpy as np

    from pbdagcon_tpu import devpipe
    from pbdagcon_tpu.devpipe import (
        DevCapsConfig, _C_LADDER, _L_LADDER, _R_LADDER, _ladder,
        choose_window_caps, ins_cap,
    )

    rng = np.random.default_rng(77)
    classes = [
        # (R, C, L, ch, sm, nd, dq, se) base values; jitter below.
        (30, 1240, 1000, 64, 9, 500, 4, 13),
        (12, 400, 300, 24, 8, 120, 3, 6),
        (60, 2500, 2000, 150, 11, 1500, 6, 15),
        (20, 700, 560, 40, 9, 260, 4, 9),
    ]

    def window_metas(cls, n):
        R, C, L, ch, sm, nd, dq, se = cls
        m = np.zeros((n, 9), dtype=np.int64)
        m[:, 0] = R + rng.integers(-2, 3, n)
        m[:, 1] = C + rng.integers(-40, 41, n)
        m[:, 2] = L + rng.integers(-20, 21, n)
        m[:, 3] = nd + rng.integers(-nd // 4, nd // 4 + 1, n)
        m[:, 4] = m[:, 1] * m[:, 0]
        m[:, 5] = ch + rng.integers(-6, 7, n)
        m[:, 6] = sm + rng.integers(-1, 2, n)
        m[:, 7] = dq + rng.integers(-1, 2, n)
        m[:, 8] = se + rng.integers(-2, 3, n)
        return m

    w_state: dict = {}
    v_state: dict = {}
    need_recent: dict = {}
    seen: dict = {}
    prof = DevCapsConfig.heavy()
    for step in range(60):
        cls = classes[int(rng.integers(0, len(classes)))]
        metas = window_metas(cls, int(rng.integers(32, 129)))
        buckets: dict = {}
        for i in range(len(metas)):
            key = (
                _ladder(int(metas[i, 0]), _R_LADDER),
                _ladder(int(metas[i, 1]), _C_LADDER),
                _ladder(int(metas[i, 2]), _L_LADDER),
            )
            assert None not in key
            buckets.setdefault(key, []).append(i)
        for (Rb, Cb, Lb), idxs in buckets.items():
            sub = metas[idxs]
            bkey = (Rb, Cb, Lb, prof.W)
            caps = choose_window_caps(
                bkey, sub, prof, w_state, v_state, need_recent
            )
            NI = ins_cap(caps)
            batched = [i for i in idxs if int(metas[i, 3]) <= NI]
            # (c) the NI filter is exact: everything batched fits.
            for i in batched:
                assert int(metas[i, 3]) <= NI
            key_caps = (caps.R, caps.C, caps.L, caps.CH, caps.SM,
                        caps.ND, caps.SE, caps.DQ, caps.V, caps.W)
            seen.setdefault(bkey, []).append((step, key_caps))
    for bkey, hist in seen.items():
        distinct = {c for _s, c in hist}
        # (a) bounded distinct compiled programs per class.
        assert len(distinct) <= 3, (bkey, distinct)
        tail = [c for s, c in hist if s >= 30]
        if len(tail) >= 3:
            # (b) no flip-flop: the tail of the stream settles on ONE
            # caps tuple per bucket.
            assert len(set(tail)) == 1, (bkey, set(tail))


def test_caps_v_alignment_fence():
    """Alignment fence: caps_for never emits an unaligned V (the
    un-aligned L + ND at the top ND rung would be V=17407): every V is
    a multiple of 256, so the blocked DP's V % 64 == 0 holds
    everywhere."""
    from pbdagcon_tpu.devpipe import DevCapsConfig, caps_for

    for L in (256, 1024, 2048, 16384):
        for nd_need in (100, 4608, 12288, 16383, 1 << 20):
            for prof in (DevCapsConfig.compact(), DevCapsConfig.heavy()):
                caps = caps_for(
                    128, 32, max(64, L + L // 4), L, prof,
                    nd_need=nd_need,
                )
                assert caps.V % 256 == 0, caps
                assert caps.V >= caps.L, caps
                assert not (caps.ND == 16383 and caps.V == 17407), caps
    # the historical crash shape itself:
    caps = caps_for(
        64, 256, 1280, 1024, DevCapsConfig.heavy(), nd_need=16383
    )
    assert caps.ND == 16383 and caps.V == 17408, caps
