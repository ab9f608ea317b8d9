"""Force W on the devbuild path and measure end-to-end rate + fallback
count on the bench workload: undersized W only flags targets to the
exact host path, so if flags stay rare the 33% band shrink is free.

    python tools/prof_w64.py [W ...]
"""
import io
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import pbdagcon_tpu.devpipe as devpipe
from pbdagcon_tpu import native
from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

ws = [int(a) for a in sys.argv[1:]] or [96, 64]
n_targets, length, cov = 512, 1000, 30
lines = []
for _t, _b, alns in simulate_targets(1234, n_targets, length, cov, NoiseProfile()):
    lines.extend(to_pre_raw(a) for a in alns)
text = ("\n".join(lines) + "\n").encode()
assert native.ensure_built()

ref = None
orig_heavy = devpipe.DevCapsConfig.heavy
for W in ws:
    devpipe.DevCapsConfig.heavy = staticmethod(
        lambda W=W: devpipe.DevCapsConfig(W=W)
    )
    cfg = DagconConfig(
        min_weight=max(2, cov // 4), min_length=100, threads=4,
        backend="devbuild", fmt="pre", align=True, batch_targets=512,
    )
    out = io.StringIO()
    t0 = time.time()
    run_stream(io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg)
    print(f"W={W} warmup {time.time()-t0:.1f}s", flush=True)
    if ref is None:
        ref = out.getvalue()
    times = []
    st = None
    for rep in range(3):
        out = io.StringIO()
        t = time.time()
        st = run_stream(io.TextIOWrapper(io.BytesIO(text)), FastaWriter(out), cfg)
        times.append(time.time() - t)
        assert out.getvalue() == ref, "parity broke across W"
    bases = sum(len(l) for l in ref.splitlines() if not l.startswith(">"))
    bt = sorted(times)[1]
    print(
        f"W={W}: median {bt:.2f}s = {bases/bt:,.0f} b/s "
        f"(runs {' '.join(f'{x:.2f}' for x in times)}, "
        f"fallbacks={st.host_fallbacks}/{st.targets})",
        flush=True,
    )
devpipe.DevCapsConfig.heavy = orig_heavy
