"""DAZZ_DB / .las reader round-trips + dazcon container frontend."""

import io as _io
import os
import random
import subprocess
import sys

import pytest

from pbdagcon_tpu import native
from pbdagcon_tpu.alignment import revcomp
from pbdagcon_tpu.simulate import random_seq

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built"
)


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _mk_db(tmp_path, seqs):
    from pbdagcon_tpu.dazzio import write_dazz_db

    path = str(tmp_path / "fix.db")
    write_dazz_db(path, seqs)
    return path


def test_db_roundtrip(tmp_path):
    from pbdagcon_tpu.dazzio import DazzDb

    rng = random.Random(5)
    seqs = [random_seq(rng, n) for n in (1, 3, 4, 5, 77, 1003)]
    path = _mk_db(tmp_path, seqs)
    with DazzDb(path) as db:
        assert len(db) == len(seqs)
        for i, s in enumerate(seqs):
            assert db.read(i) == s


def test_las_roundtrip(tmp_path):
    from pbdagcon_tpu.dazzio import Overlap, read_las, write_las

    ovls = [
        Overlap(0, 1, False, 10, 90, 0, 82, 7),
        Overlap(0, 2, True, 0, 100, 5, 103, 11),
        Overlap(3, 1, False, 40, 70, 12, 41, 2),
    ]
    path = str(tmp_path / "fix.las")
    write_las(path, ovls)
    assert read_las(path) == ovls


def test_dazcon_container_frontend(tmp_path):
    """tpu-dazcon db.db ovl.las == the FASTA+M4 path on the same data."""
    from pbdagcon_tpu.dazzio import Overlap, write_las
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup

    rng = random.Random(99)
    bb, alns = simulate_pileup(rng, "0", 400, 12, NoiseProfile())
    seqs = [bb]
    ovls = []
    m4_lines = []
    for i, a in enumerate(alns, start=1):
        q = a.qstr.replace("-", "")
        comp = i % 3 == 0
        seqs.append(revcomp(q) if comp else q)
        ovls.append(
            Overlap(0, i, comp, a.start - 1, a.end, 0, len(q), 5)
        )
        m4_lines.append(
            f"{i} 0 5 90.0 {1 if comp else 0} 0 {len(q)} {len(q)} "
            f"0 {a.start - 1} {a.end} {len(bb)}"
        )
    db = _mk_db(tmp_path, seqs)
    las = str(tmp_path / "ovl.las")
    write_las(las, ovls)
    fasta = tmp_path / "reads.fa"
    with open(fasta, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{i}\n{s}\n")
    m4 = tmp_path / "ovl.m4"
    with open(m4, "w") as f:
        f.write("\n".join(m4_lines) + "\n")

    env = {"PYTHONPATH": _ROOT, "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    r1 = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu.dazcon", las, db,
         "-c", "2", "-m", "50"],
        capture_output=True, text=True, env=env,
    )
    assert r1.returncode == 0, r1.stderr
    r2 = subprocess.run(
        [sys.executable, "-m", "pbdagcon_tpu.dazcon", str(m4),
         str(fasta), "-c", "2", "-m", "50"],
        capture_output=True, text=True, env=env,
    )
    assert r2.returncode == 0, r2.stderr
    assert r1.stdout == r2.stdout
    assert r1.stdout.startswith(">0\n")


def test_las_trace_roundtrip_u8(tmp_path):
    """Trace-point decoding (align.c capability): u8 traces round-trip
    through write_las/read_las at tspace <= 125."""
    from pbdagcon_tpu.dazzio import Overlap, las_tspace, read_las, write_las

    ovls = [
        Overlap(0, 1, False, 0, 250, 3, 259, 9,
                trace=((4, 98), (3, 101), (2, 55))),
        Overlap(0, 2, True, 100, 180, 0, 83, 4, trace=((4, 83),)),
        Overlap(1, 2, False, 5, 20, 1, 17, 0, trace=()),
    ]
    path = str(tmp_path / "t8.las")
    write_las(path, ovls, tspace=100)
    assert las_tspace(path) == 100
    got = read_las(path, with_traces=True)
    assert [o.trace for o in got] == [o.trace for o in ovls]
    assert [(o.aread, o.bread, o.diffs) for o in got] == [
        (o.aread, o.bread, o.diffs) for o in ovls
    ]
    # default read skips traces but must still parse records correctly
    plain = read_las(path)
    assert [(o.abpos, o.aepos) for o in plain] == [
        (o.abpos, o.aepos) for o in ovls
    ]


def test_las_trace_roundtrip_u16(tmp_path):
    """u16 traces (tspace > 125) with values beyond the u8 range."""
    from pbdagcon_tpu.dazzio import Overlap, las_tspace, read_las, write_las

    ovls = [
        Overlap(2, 7, True, 0, 3000, 0, 3100, 40,
                trace=((30, 1020), (17, 995), (25, 1085))),
    ]
    path = str(tmp_path / "t16.las")
    write_las(path, ovls, tspace=1000)
    assert las_tspace(path) == 1000
    got = read_las(path, with_traces=True)
    assert got[0].trace == ovls[0].trace


class TestQvStreams:
    """Round-trip of the .qvs QV-stream codec (QV.{h,c} capability,
    SURVEY.md §2 C9): write_dazz_qvs -> native dazz_qv_open/load."""

    def _mk(self, tmp_path, seqs, rng, skew=False):
        from pbdagcon_tpu.dazzio import (
            QV_TRACKS, DazzQv, write_dazz_db, write_dazz_qvs,
        )

        db = str(tmp_path / "qvfix.db")
        write_dazz_db(db, seqs)
        tracks = []
        for s in seqs:
            per = []
            for t in range(5):
                if skew and t == 0:
                    # heavily skewed histogram (one dominant symbol)
                    vals = rng.choice(
                        [7, 40, 41, 42], size=len(s),
                        p=[0.97, 0.01, 0.01, 0.01],
                    )
                elif t == 1:
                    vals = rng.integers(65, 69, size=len(s))  # tag bases
                else:
                    vals = rng.integers(0, 94, size=len(s))
                per.append(bytes(int(v) for v in vals))
            tracks.append(tuple(per))
        write_dazz_qvs(db, tracks)
        return db, tracks

    def test_roundtrip(self, tmp_path):
        import numpy as np

        from pbdagcon_tpu.dazzio import QV_TRACKS, DazzQv

        rng = np.random.default_rng(7)
        seqs = ["ACGT" * 30, "A" * 17, "GATTACA" * 9]
        db, tracks = self._mk(tmp_path, seqs, rng)
        with DazzQv(db) as qv:
            for i, s in enumerate(seqs):
                got = qv.load(i, len(s))
                for t, name in enumerate(QV_TRACKS):
                    assert got[name] == tracks[i][t], (i, name)

    def test_roundtrip_skewed_and_single_symbol(self, tmp_path):
        import numpy as np

        from pbdagcon_tpu.dazzio import QV_TRACKS, DazzQv

        rng = np.random.default_rng(11)
        seqs = ["ACGTTGCA" * 16, "C" * 5]
        db, tracks = self._mk(tmp_path, seqs, rng, skew=True)
        # overwrite track 4 with a single-symbol stream everywhere
        from pbdagcon_tpu.dazzio import write_dazz_qvs

        tracks = [
            (tr[0], tr[1], tr[2], tr[3], bytes([33]) * len(s))
            for tr, s in zip(tracks, seqs)
        ]
        write_dazz_qvs(db, tracks)
        with DazzQv(db) as qv:
            for i, s in enumerate(seqs):
                got = qv.load(i, len(s))
                for t, name in enumerate(QV_TRACKS):
                    assert got[name] == tracks[i][t], (i, name)

    def test_empty_read_and_missing_qvs(self, tmp_path):
        import numpy as np
        import pytest

        from pbdagcon_tpu.dazzio import DazzQv, write_dazz_db

        rng = np.random.default_rng(3)
        seqs = ["ACG", ""]
        db, tracks = self._mk(tmp_path, seqs, rng)
        with DazzQv(db) as qv:
            assert qv.load(1, 0) == {k: b"" for k in (
                "delQV", "delTag", "insQV", "mergeQV", "subQV")}
        other = str(tmp_path / "noqv.db")
        write_dazz_db(other, ["ACGT"])
        with pytest.raises(OSError):
            DazzQv(other)


class TestHostileContainers:
    """Corrupt/truncated/foreign container files must fail the open (or
    the load) with a clean OSError — never crash or return garbage
    (VERDICT r2 #8; ref DB.c::Open_DB error paths, SURVEY.md §2 C9)."""

    def _paths(self, tmp_path, name="fix.db"):
        import os

        db = str(tmp_path / name)
        d = os.path.dirname(db)
        root = os.path.basename(db)[: -len(".db")]
        return db, os.path.join(d, f".{root}.idx"), os.path.join(
            d, f".{root}.bps"
        )

    def _fresh(self, tmp_path, name):
        import random as _r

        from pbdagcon_tpu.dazzio import write_dazz_db

        rng = _r.Random(17)
        db, idx, bps = self._paths(tmp_path, name)
        write_dazz_db(db, [random_seq(rng, n) for n in (40, 80, 160)])
        return db, idx, bps

    def test_truncated_idx(self, tmp_path):
        import pytest

        from pbdagcon_tpu.dazzio import DazzDb

        db, idx, _ = self._fresh(tmp_path, "t1.db")
        data = open(idx, "rb").read()
        for cut in (0, 60, len(data) - 7):
            with open(idx, "wb") as f:
                f.write(data[:cut])
            with pytest.raises(OSError):
                DazzDb(db)

    def test_truncated_bps(self, tmp_path):
        import pytest

        from pbdagcon_tpu.dazzio import DazzDb

        db, _, bps = self._fresh(tmp_path, "t2.db")
        data = open(bps, "rb").read()
        with open(bps, "wb") as f:
            f.write(data[: len(data) // 2])
        with pytest.raises(OSError):
            DazzDb(db)

    def test_bitflipped_boff_and_rlen(self, tmp_path):
        import struct

        import pytest

        from pbdagcon_tpu.dazzio import DazzDb

        # Huge boff on read 1 -> points past .bps -> clean open failure.
        db, idx, _ = self._fresh(tmp_path, "t3.db")
        data = bytearray(open(idx, "rb").read())
        off = 112 + 1 * 40 + 16  # read 1's boff field
        data[off : off + 8] = struct.pack("<q", 1 << 40)
        open(idx, "wb").write(bytes(data))
        with pytest.raises(OSError):
            DazzDb(db)
        # Negative rlen on read 0.
        db, idx, _ = self._fresh(tmp_path, "t4.db")
        data = bytearray(open(idx, "rb").read())
        data[112 + 4 : 112 + 8] = struct.pack("<i", -5)
        open(idx, "wb").write(bytes(data))
        with pytest.raises(OSError):
            DazzDb(db)

    def test_foreign_idx_header(self, tmp_path):
        import pytest

        from pbdagcon_tpu.dazzio import DazzDb

        db, idx, bps = self._paths(tmp_path, "t5.db")
        open(idx, "wb").write(b"\xff" * 200)  # ureads = huge/negative
        open(bps, "wb").write(b"\x00" * 10)
        with pytest.raises(OSError):
            DazzDb(db)

    def test_truncated_and_foreign_las(self, tmp_path):
        import struct

        import pytest

        from pbdagcon_tpu.dazzio import Overlap, read_las, write_las

        path = str(tmp_path / "t.las")
        ovls = [
            Overlap(0, 1, False, 10, 90, 0, 82, 7,
                    trace=((3, 50), (4, 40)))
        ]
        write_las(path, ovls, tspace=100)
        data = open(path, "rb").read()
        # Truncate mid-record and mid-trace.
        for cut in (8, 20, len(data) - 1):
            open(path, "wb").write(data[:cut])
            with pytest.raises(OSError):
                read_las(path)
        # novl beyond what the file can hold.
        bad = bytearray(data)
        bad[0:8] = struct.pack("<q", 1 << 30)
        open(path, "wb").write(bytes(bad))
        with pytest.raises(OSError):
            read_las(path)
        # Negative tspace.
        bad = bytearray(data)
        bad[8:12] = struct.pack("<i", -1)
        open(path, "wb").write(bytes(bad))
        with pytest.raises(OSError):
            read_las(path)

    def test_corrupt_qvs(self, tmp_path):
        import os
        import random as _r

        import numpy as np
        import pytest

        from pbdagcon_tpu.dazzio import (
            QV_TRACKS, DazzQv, write_dazz_db, write_dazz_qvs,
        )

        rng = np.random.default_rng(4)
        db = str(tmp_path / "q.db")
        seqs = ["ACGTACGTAA", "GGTTAACC"]
        write_dazz_db(db, seqs)
        tracks = [
            tuple(
                bytes(rng.integers(0, 50, size=len(s)).astype(np.uint8))
                for _ in range(len(QV_TRACKS))
            )
            for s in seqs
        ]
        write_dazz_qvs(db, tracks)
        d = os.path.dirname(db)
        qvs = os.path.join(d, ".q.qvs")
        data = open(qvs, "rb").read()
        # Truncated payload: open may succeed, load must raise.
        open(qvs, "wb").write(data[: len(data) - 4])
        with pytest.raises(OSError):
            with DazzQv(db) as qv:
                qv.load(1, len(seqs[1]))
        # Truncated table region: open fails.
        open(qvs, "wb").write(data[:6])
        with pytest.raises(OSError):
            DazzQv(db)
        # Wrong track count.
        import struct

        bad = bytearray(data)
        bad[0:4] = struct.pack("<i", 9)
        open(qvs, "wb").write(bytes(bad))
        with pytest.raises(OSError):
            DazzQv(db)


class TestUpstreamLayoutPins:
    """Pin the on-disk constants to the published DAZZ_DB/DALIGNER
    struct definitions (DB.h HITS_DB/HITS_READ, align.h Path/Overlap,
    align.c Write_Overlap) so they cannot silently drift back to the
    round-1/2 reconstructions (which were wrong by 8/4 bytes and
    swapped the Path coordinate pairs)."""

    def test_idx_header_is_sizeof_hits_db(self):
        from pbdagcon_tpu.dazzio import _IDX_HEADER, _READ_REC

        # HITS_DB on LP64: 4*4 (ureads/treads/cutoff/allarr) + 16
        # (freq[4]) + 4 (maxlen) + 4 pad + 8 (totlen) + 5*4 (nreads/
        # trimmed/part/ufirst/tfirst) + 4 pad + 5*8 (pointer slots).
        assert _IDX_HEADER == 16 + 16 + 4 + 4 + 8 + 20 + 4 + 40 == 112
        # HITS_READ: 3*4 + 4 pad + 8 + 8 + 4 + 4 pad.
        assert _READ_REC == 40

    def test_las_header_and_overlap_record(self, tmp_path):
        import struct

        from pbdagcon_tpu.dazzio import (
            _LAS_HEADER, _OVL_REC, Overlap, write_las,
        )

        # align.c writes int64 novl then int tspace as two separate
        # fwrites: 12 bytes, NO struct padding.
        assert _LAS_HEADER == 12
        # sizeof(Overlap) - sizeof(void*) = 48 - 8.
        assert _OVL_REC == 40
        las = str(tmp_path / "pin.las")
        write_las(
            las,
            [Overlap(aread=7, bread=9, comp=False, abpos=11, aepos=22,
                     bbpos=33, bepos=44, diffs=5, trace=((1, 2),))],
            tspace=100,
        )
        raw = open(las, "rb").read()
        (novl,) = struct.unpack_from("<q", raw, 0)
        (tspace,) = struct.unpack_from("<i", raw, 8)
        assert (novl, tspace) == (1, 100)
        rec = raw[_LAS_HEADER : _LAS_HEADER + _OVL_REC]
        tlen, diffs, abpos, bbpos, aepos, bepos = struct.unpack_from(
            "<6i", rec, 0
        )
        # Path stores the BEGIN pair then the END pair.
        assert (abpos, bbpos, aepos, bepos) == (11, 33, 22, 44)
        assert (tlen, diffs) == (2, 5)
        flags, aread, bread = struct.unpack_from("<Iii", rec, 24)
        assert (aread, bread) == (7, 9)
