"""Devbuild end-to-end rate vs window size (batch_targets): smaller
windows pipeline encode/dispatch/fetch across windows; one giant window
serializes the host encode in front of the first dispatch.

    python tools/prof_devpipe_win.py [win ...]
"""
import io
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from pbdagcon_tpu import native
from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

wins = [int(a) for a in sys.argv[1:]] or [512, 128]
n_targets, length, cov = 512, 1000, 30
lines = []
for _t, _b, alns in simulate_targets(1234, n_targets, length, cov, NoiseProfile()):
    lines.extend(to_pre_raw(a) for a in alns)
text = ("\n".join(lines) + "\n").encode()
assert native.ensure_built()

ref = None
for win in wins:
    cfg = DagconConfig(
        min_weight=max(2, cov // 4), min_length=100, threads=4,
        backend="devbuild", fmt="pre", align=True, batch_targets=win,
    )
    out = io.StringIO()
    t0 = time.time()
    run_stream(io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg)
    print(f"win={win} warmup {time.time()-t0:.1f}s", flush=True)
    if ref is None:
        ref = out.getvalue()
    best = []
    for rep in range(3):
        out = io.StringIO()
        t = time.time()
        st = run_stream(io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg)
        dt = time.time() - t
        best.append(dt)
        assert out.getvalue() == ref, "parity broke across window sizes"
    bases = sum(len(l) for l in ref.splitlines() if not l.startswith(">"))
    bt = sorted(best)[1]
    print(
        f"win={win}: median {bt:.2f}s = {bases/bt:,.0f} b/s "
        f"(runs {' '.join(f'{x:.2f}' for x in best)}, "
        f"fallbacks={st.host_fallbacks})",
        flush=True,
    )
