import os, sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time
import numpy as np
from pbdagcon_tpu.config import enable_compile_cache
enable_compile_cache()
import jax, jax.numpy as jnp
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw
from pbdagcon_tpu.aligner import band_halfwidth
from pbdagcon_tpu.ops import align_tpu as A

n, length, cov = 300, 1000, 30
pairs = []
for _tid, _bb, alns in simulate_targets(1234, n, length, cov, NoiseProfile()):
    for a in alns:
        f = to_pre_raw(a).split()
        pairs.append((f[5], f[6]))
todo = list(range(4096))
ms = np.array([len(pairs[i][0]) for i in todo], dtype=np.int32)
ns = np.array([len(pairs[i][1]) for i in todo], dtype=np.int32)
bws = np.array([band_halfwidth(int(a), int(b)) for a, b in zip(ms, ns)], dtype=np.int32)
M = -(-int(ms.max()) // 256) * 256
N = int(ns.max())
dmin = int(min(0, (ns - ms).min()) - bws.max()) - 1
dmin = -(-(-dmin) // 64) * -64
dmax = int(max(0, (ns - ms).max()) + bws.max()) + 1
Wa = dmax - dmin + 1
Wa = -(-Wa // 128) * 128
print(f"B=4096 M={M} N={N} Wa={Wa} dmin={dmin}")
Bp = 4096
qb = np.zeros((Bp, M), dtype=np.uint8)
tb_pad = np.zeros((Bp, max(M, N + 1 - dmin) + Wa + 2), dtype=np.uint8)
for k, i in enumerate(todo):
    q, t = pairs[i]
    qb[k, : len(q)] = np.frombuffer(q.encode(), np.uint8)
    tb_pad[k, 1 - dmin : 1 - dmin + len(t)] = np.frombuffer(t.encode(), np.uint8)

qbj, tbj, msj, nsj, bwsj = map(jnp.asarray, (qb, tb_pad, ms, ns, bws))
# warm
packed = A._align_scan(qbj, tbj, msj, nsj, bwsj, M=M, Wa=Wa, dmin=dmin)
packed.block_until_ready()
t0=time.time(); packed = A._align_scan(qbj, tbj, msj, nsj, bwsj, M=M, Wa=Wa, dmin=dmin); packed.block_until_ready()
t_scan = time.time()-t0
Np = -(-N // 256) * 256
L = M + Np
mv = A._traceback_scan(packed, msj, nsj, M=M, Wa=Wa, dmin=dmin, L=L)
mv.block_until_ready()
t0=time.time(); mv = A._traceback_scan(packed, msj, nsj, M=M, Wa=Wa, dmin=dmin, L=L); mv.block_until_ready()
t_tb = time.time()-t0
t0=time.time(); moves = np.asarray(mv); t_fetch = time.time()-t0
print(f"align_scan: {t_scan:.3f}s  traceback_scan: {t_tb:.3f}s  fetch[{moves.nbytes/1e6:.1f}MB]: {t_fetch:.3f}s")

# per-stage forced materialization via scalar fetch
import jax
def force(x):
    return float(jnp.max(x.astype(jnp.float32) if x.dtype==jnp.uint8 else x.astype(jnp.float32)))
t0=time.time(); qbj2=jax.device_put(qb); tbj2=jax.device_put(tb_pad); _=force(qbj2[:, :1]); _=force(tbj2[:, :1]); t_up=time.time()-t0
t0=time.time(); packed2 = A._align_scan(qbj2, tbj, msj, nsj, bwsj, M=M, Wa=Wa, dmin=dmin); _=force(packed2[:1, :1, :1]); t_scan2=time.time()-t0
t0=time.time(); mv2 = A._traceback_scan(packed2, msj, nsj, M=M, Wa=Wa, dmin=dmin, L=L); _=force(mv2[:1, :1]); t_tb2=time.time()-t0
t0=time.time(); moves2 = np.asarray(mv2); t_f2=time.time()-t0
print(f"upload: {t_up:.3f}s  align_scan: {t_scan2:.3f}s  traceback: {t_tb2:.3f}s  fetch: {t_f2:.3f}s")
print(f"dist of n-m: min={int((ns-ms).min())} max={int((ns-ms).max())} p50={int(np.percentile(ns-ms,50))} p95={int(np.percentile(ns-ms,95))} bw max={int(bws.max())}")
