"""Randomized end-to-end soak: backend=devbuild vs host over the CLI
pipeline (CPU). Usage: python tools/soak_devbuild.py [trials] [offset].

Every random shape combination compiles fresh XLA:CPU programs whose
JIT code mappings stay mapped for as long as the jit cache holds the
executable — a 12-trial run was measured at 36k maps against the
65,530 per-process vm.max_map_count limit. jax.clear_caches() after
each trial releases them; re-exec'ing in SOAK_CHUNK-trial subprocesses
(default 12) is kept as a belt-and-braces backstop."""
import io as _io
import os
import random
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

trials = int(sys.argv[1]) if len(sys.argv) > 1 else 40
offset = int(sys.argv[2]) if len(sys.argv) > 2 else 0
CHUNK = int(os.environ.get("SOAK_CHUNK", "12"))
if offset == 0 and trials > CHUNK:
    rc_all = 0
    for lo in range(0, trials, CHUNK):
        n = min(CHUNK, trials - lo)
        rc = subprocess.call(
            [sys.executable, os.path.abspath(__file__), str(n), str(lo)]
        )
        rc_all |= rc
    sys.exit(rc_all)

import jax

jax.config.update("jax_platforms", "cpu")

from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup, to_m5, to_pre
profiles = [
    NoiseProfile(),
    NoiseProfile(sub=0.05, ins=0.2, dele=0.1),
    NoiseProfile(sub=0.02, ins=0.25, dele=0.12, max_ins_run=5),
]
fails = 0
fallbacks = targets = 0
for trial in range(offset, offset + trials):
    rng = random.Random(90_000 + trial)
    fmt = rng.choice(["m5", "pre"])
    lines = []
    nt = rng.randint(1, 6)
    for t in range(nt):
        bb, alns = simulate_pileup(
            rng, f"t{trial}_{t}", rng.randint(40, 900),
            rng.randint(2, 70), profiles[trial % 3],
        )
        for a in alns:
            lines.append(
                to_m5(a, flip=rng.random() < 0.3) if fmt == "m5"
                else to_pre(a)
            )
    text = "\n".join(lines) + "\n"
    kw = dict(
        fmt=fmt,
        min_weight=rng.choice([1, 2, 4, 8]),
        min_length=rng.choice([1, 25, 100]),
        trim=rng.choice([0, 0, 3]),
    )
    b1, b2 = _io.StringIO(), _io.StringIO()
    run_stream(_io.StringIO(text), FastaWriter(b1),
               DagconConfig(backend="host", use_native=True, **kw))
    st = run_stream(_io.StringIO(text), FastaWriter(b2),
                    DagconConfig(backend="devbuild", use_native=True, **kw))
    targets += st.targets
    fallbacks += st.host_fallbacks
    if b1.getvalue() != b2.getvalue():
        fails += 1
        print(f"FAIL trial {trial} ({kw})", flush=True)
    jax.clear_caches()  # drop jit executables -> unmap their JIT code
print(f"soak: {trials} trials, {fails} fails, "
      f"fallbacks {fallbacks}/{targets} targets")
sys.exit(1 if fails else 0)
