"""Trace-guided re-alignment (VERDICT r2 #6): the banded DP follows the
.las trace-point path instead of the straight diagonal. Guided output
must be byte-identical to unguided on realistic pileups, and the
container CLI must produce identical FASTA with --trace-guided."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from pbdagcon_tpu import native
from pbdagcon_tpu.aligner import align_pair
from pbdagcon_tpu.alignment import revcomp
from pbdagcon_tpu.dazcon import trace_guide
from pbdagcon_tpu.dazzio import Overlap, traces_from_alignment
from pbdagcon_tpu.simulate import NoiseProfile, random_seq, simulate_pileup


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _mutate(rng, t, sub=0.08, ins=0.08, dele=0.06):
    out = []
    for c in t:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(rng.choice("ACGT".replace(c, "")))
        else:
            out.append(c)
        while rng.random() < ins:
            out.append(rng.choice("ACGT"))
    return "".join(out)


def _guide_for(q, t, qs, ts, tspace=100):
    tr = traces_from_alignment(qs, ts, abpos=0, tspace=tspace)
    o = Overlap(0, 1, False, 0, len(t), 0, len(q), sum(d for d, _ in tr),
                trace=tr)
    return trace_guide(o, tspace)


def test_traces_from_alignment_invariants():
    rng = random.Random(5)
    t = random_seq(rng, 730)
    q = _mutate(rng, t)
    qs, ts = align_pair(q, t)
    tr = traces_from_alignment(qs, ts, abpos=0, tspace=100)
    assert sum(y for _d, y in tr) == len(q)
    # segments cover the target in tspace chunks (last partial)
    assert len(tr) == -(-len(t) // 100)


@pytest.mark.parametrize("seed,tlen", [(1, 400), (2, 1000), (3, 2500)])
def test_guided_matches_unguided_bitwise(seed, tlen):
    rng = random.Random(seed)
    t = random_seq(rng, tlen)
    q = _mutate(rng, t)
    qs, ts = align_pair(q, t)
    guide = _guide_for(q, t, qs, ts)
    assert guide is not None
    gq, gt = align_pair(q, t, guide=guide)
    assert (gq, gt) == (qs, ts), "guided banding changed the alignment"


def test_trace_guide_rejects_inconsistent_and_comp():
    tr = ((3, 50), (4, 40))
    o = Overlap(0, 1, True, 0, 150, 0, 90, 7, trace=tr)  # comp
    assert trace_guide(o, 100) is None
    o2 = Overlap(0, 1, False, 0, 150, 0, 91, 7, trace=tr)  # y sum != m
    assert trace_guide(o2, 100) is None
    o3 = Overlap(0, 1, False, 0, 150, 0, 90, 7, trace=tr)
    g = trace_guide(o3, 100)
    assert g is not None
    q_ck, t_ck, w = g
    assert q_ck[0] == 0 and q_ck[-1] == 90
    assert t_ck[0] == 0 and t_ck[-1] == 150
    assert list(t_ck) == [0, 100, 150]
    assert len(w) == 2 and all(wk >= 32 for wk in w)


@pytest.mark.skipif(not native.ensure_built(), reason="no native engine")
def test_dazcon_trace_guided_cli_parity(tmp_path):
    """tpu-dazcon --trace-guided over .las+db == the unguided run."""
    from pbdagcon_tpu.dazzio import write_dazz_db, write_las

    rng = random.Random(77)
    bb, alns = simulate_pileup(rng, "0", 500, 10, NoiseProfile())
    seqs = [bb]
    ovls = []
    for i, a in enumerate(alns, start=1):
        q = a.qstr.replace("-", "")
        comp = i % 4 == 0  # comp overlaps align unguided (no traces)
        seqs.append(revcomp(q) if comp else q)
        tr = () if comp else traces_from_alignment(
            a.qstr, a.tstr, abpos=a.start - 1, tspace=100
        )
        ovls.append(
            Overlap(0, i, comp, a.start - 1, a.end, 0, len(q), 5,
                    trace=tr)
        )
    db = str(tmp_path / "fix.db")
    write_dazz_db(db, seqs)
    las = str(tmp_path / "ovl.las")
    write_las(las, ovls, tspace=100)

    env = {"PYTHONPATH": _ROOT, "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    outs = []
    for extra in ([], ["--trace-guided"]):
        r = subprocess.run(
            [sys.executable, "-m", "pbdagcon_tpu.dazcon", las, db,
             "-c", "2", "-m", "50"] + extra,
            capture_output=True, text=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1], "--trace-guided changed the consensus"
    assert outs[0].startswith(">0\n")
