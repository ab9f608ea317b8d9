import os, sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import os, time
from pbdagcon_tpu.config import enable_compile_cache
enable_compile_cache()
import jax
print("platform:", jax.devices()[0].platform)
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw
from pbdagcon_tpu.ops.align_tpu import align_batch

n, length, cov = 300, 1000, 30
pairs = []
for _tid, _bb, alns in simulate_targets(1234, n, length, cov, NoiseProfile()):
    for a in alns:
        f = to_pre_raw(a).split()
        pairs.append((f[5], f[6]))
print("reads:", len(pairs))
_ = align_batch(pairs[:256])  # warmup small
for B in (1024, 2048, 4096, 8192):
    _ = align_batch(pairs[:B])  # warm compile for this shape
    t0=time.time(); _ = align_batch(pairs[:B]); dt=time.time()-t0
    print(f"align_batch B={B}: {dt:.3f}s -> {B/dt:,.0f} reads/s")
