"""Debug driver: device_build vs numpy oracle on small fixtures (CPU)."""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

from pbdagcon_tpu.ops import devbuild as dbn
from pbdagcon_tpu.ops import devbuild_jax as dbj
from pbdagcon_tpu.simulate import NoiseProfile
from tests.test_devbuild_jax import _mk, batch_encode

caps = dbj.Caps(B=4, R=12, C=120, L=56, CH=32, SM=8, NC=384, ND=256,
                SE=8, DQ=8, V=320, W=64)
encs = [
    _mk(101, L=50, depth=8), _mk(102, L=56, depth=10),
    _mk(103, L=20, depth=3),
    _mk(104, L=40, depth=6, noise=NoiseProfile(sub=0.02, ins=0.3, dele=0.15)),
]
ops, starts, bb, ins, Lr = batch_encode(encs, caps)
out = jax.tree_util.tree_map(
    np.asarray, dbj.device_build(ops, starts, bb, ins, Lr, caps)
)
for b in range(4):
    lin, flags, keys = dbn.build_linear(encs[b])
    if lin is None:
        print(f"t{b}: oracle flagged {flags}")
        continue
    print(f"t{b}: dev flags={out['flags'][b]} n dev={out['n'][b]} np={lin.n}")
    bad = 0
    for v in range(lin.n):
        dv = (out["base"][b, v], out["weight"][b, v], out["bbpos"][b, v],
              out["cov"][b, v], out["unsup"][b, v])
        nv = (lin.base[v], lin.weight[v], lin.bb[v], lin.cov[v],
              lin.unsup[v])
        if tuple(int(x) for x in dv) != tuple(int(x) for x in nv):
            if bad < 5:
                print(f"  v={v} dev={dv} np={nv}")
            bad += 1
    print(f"  node-attr mismatches: {bad}")

# band comparison detail
from tests.test_devbuild_jax import _np_band
for b in range(4):
    lin, flags, keys = dbn.build_linear(encs[b])
    if lin is None or out["flags"][b]:
        continue
    win, wkey, xc, xk = _np_band(lin, keys, caps.V, caps.W)
    dv = out["win"][b]
    bad = np.argwhere(dv != win)
    for v, d in bad[:6]:
        print(f"t{b} win[{v},{d}]: dev={dv[v,d]} np={win[v,d]} "
              f"(node bb={lin.bb[v] if v < lin.n else '?'} "
              f"base={chr(lin.base[v]) if v < lin.n else '?'})")
    xbad = np.argwhere(out["exit_cnt"][b] != xc)
    for (v,) in xbad[:6]:
        print(f"t{b} exit[{v}]: dev={out['exit_cnt'][b][v]} np={xc[v]}")
    kb = (win >= 0) & (out["wkey"][b] != wkey)
    for v, d in np.argwhere(kb)[:6]:
        print(f"t{b} wkey[{v},{d}]: dev={out['wkey'][b][v,d]:x} np={wkey[v,d]:x}")
