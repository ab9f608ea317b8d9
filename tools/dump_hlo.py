"""Dump optimized HLO of the compiled device_build at bench caps.

    python tools/dump_hlo.py /tmp/build_hlo.txt
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main() -> int:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/build_hlo.txt"
    n_targets, cov, length = 128, 30, 1000

    import jax

    from pbdagcon_tpu import native
    from pbdagcon_tpu.devpipe import (
        DevCapsConfig, _B_LADDER, _C_LADDER, _L_LADDER, _R_LADDER,
        _ladder, caps_for, ins_cap,
    )
    from pbdagcon_tpu.ops import devbuild_jax as dj
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

    assert native.ensure_built()
    lines = []
    for _tid, _bb, alns in simulate_targets(
        1234, n_targets, length, cov, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    eng = native.NativeEngine(
        min_weight=max(2, cov // 4), min_length=100, threads=4, align=True
    )
    count = eng.encode_text(("\n".join(lines) + "\n").encode(),
                            fmt="pre", flush=True)
    metas = eng.enc_metas(count)
    dcfg = (
        DevCapsConfig.compact()
        if int(metas[:, 3].sum()) <= 0.11 * max(1, int(metas[:, 4].sum()))
        else DevCapsConfig.heavy()
    )
    caps = caps_for(
        _ladder(count, _B_LADDER) or _B_LADDER[-1],
        _ladder(int(metas[:, 0].max()), _R_LADDER),
        _ladder(int(metas[:, 1].max()), _C_LADDER),
        _ladder(int(metas[:, 2].max()), _L_LADDER),
        dcfg,
        ch_need=int(metas[:, 5].max()), sm_need=int(metas[:, 6].max()),
        nd_need=int(metas[:, 3].max()), dq_need=int(metas[:, 7].max()),
        se_need=int(metas[:, 8].max()), w_need=64,
    )
    print(f"caps: {caps}", file=sys.stderr)
    NI = ins_cap(caps)
    part = [i for i in range(count) if int(metas[i, 3]) <= NI][: caps.B]
    arrs = eng.enc_fill(part, caps.R, caps.C, caps.L, NI, B=caps.B)
    d = tuple(jax.device_put(np.asarray(a)) for a in arrs)

    f = jax.jit(lambda *a: dj.device_build(*a, caps))
    txt = f.lower(*d).compile().as_text()
    with open(out_path, "w") as fh:
        fh.write(txt)
    print(f"wrote {len(txt)} bytes to {out_path}", file=sys.stderr)
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
