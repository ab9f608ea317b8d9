"""Stage-level profile of the host-build + device-DP (backend=xla) path
on the bench workload: where does the 1.8s device run go vs the 1.16s
host-mt run? Measures (on this box):
  1. linearize_text, threads=N  (parse+align+normalize+build+linearize+export)
  2. pack_batch memcpy for all targets
  3. target_scores on host (the stage the chip replaces)
  4. target_consensus emit loop (backtrack+assembly)
  5. consensus_text all-threads (the host-mt whole-program anchor)
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import numpy as np

from pbdagcon_tpu import native
from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.pipeline import _choose_layout_native
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

n_targets, length, cov = 512, 1000, 30
lines = []
for _tid, _bb, alns in simulate_targets(1234, n_targets, length, cov, NoiseProfile()):
    lines.extend(to_pre_raw(a) for a in alns)
text = ("\n".join(lines) + "\n").encode()
print(f"workload: {len(text)/1e6:.1f} MB", flush=True)

assert native.ensure_built()
cfg = DagconConfig(
    min_weight=max(2, cov // 4), min_length=100,
    threads=os.cpu_count() or 4, backend="xla", fmt="pre", align=True,
)

for rep in range(2):
    eng = native.NativeEngine(
        min_weight=cfg.min_weight, min_length=cfg.min_length,
        threads=cfg.threads, align=True,
    )
    t = time.time()
    cnt = eng.linearize_text(text, fmt="pre", flush=True)
    t_lin = time.time() - t
    metas = eng.metas(cnt)
    ns = metas[:, 0]

    idxs = list(range(cnt))
    V = 5632
    t = time.time()
    W, K, outliers = _choose_layout_native(eng, idxs, cfg)
    t_layout = time.time() - t
    idxs = [i for i in idxs if i not in outliers]
    t = time.time()
    batches = []
    for j0 in range(0, len(idxs), 256):
        part = idxs[j0 : j0 + 256]
        batches.append(eng.pack_batch(part, V, W, K, b_pad=256))
    t_pack = time.time() - t

    t = time.time()
    scores = {}
    for i in idxs:
        scores[i] = eng.target_scores(i, int(ns[i]))
    t_hostdp = time.time() - t

    t = time.time()
    outlen = 0
    for i in range(cnt):
        s = scores.get(i)
        if s is None:
            s = eng.target_scores(i, int(ns[i]))
        txt = eng.target_consensus(i, s)
        outlen += len(txt)
    t_emit = time.time() - t
    eng.close()

    with native.NativeEngine(
        min_weight=cfg.min_weight, min_length=cfg.min_length,
        threads=cfg.threads, align=True,
    ) as eng2:
        t = time.time()
        fasta = eng2.consensus_text(text, fmt="pre")
        t_mt = time.time() - t
    print(
        f"rep{rep}: linearize(threads={cfg.threads})={t_lin:.2f}s "
        f"layout={t_layout:.2f}s pack={t_pack:.2f}s "
        f"hostDP(1core)={t_hostdp:.2f}s emit={t_emit:.2f}s "
        f"| consensus_text(mt)={t_mt:.2f}s W={W} K={K} "
        f"outliers={len(outliers)}",
        flush=True,
    )
