"""Op-level profile of one jitted device_build execution on the chip:
jax.profiler trace -> tensorboard_plugin_profile op_profile -> top ops
by self time.

    python tools/prof_trace.py [n_targets] [cov]
"""
import glob
import json
import os
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main() -> int:
    n_targets = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    cov = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    length = 1000

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
    NI = ins_cap(caps)
    part = [i for i in range(count) if int(metas[i, 3]) <= NI][: caps.B]
    arrs = eng.enc_fill(part, caps.R, caps.C, caps.L, NI, B=caps.B)
    d = tuple(jax.device_put(np.asarray(a)) for a in arrs)

    f = jax.jit(lambda *a: dj.device_build(*a, caps))
    jax.block_until_ready(f(*d))  # compile
    tdir = tempfile.mkdtemp(prefix="jaxtrace_")
    with jax.profiler.trace(tdir):
        for _ in range(3):
            out = f(*d)
        jax.block_until_ready(out)

    # parse the xplane into an op profile
    from tensorboard_plugin_profile.convert import raw_to_tool_data as rtd

    xs = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True)
    print(f"xplane files: {xs}", file=sys.stderr)
    data, _ = rtd.xspace_to_tool_data(xs, "op_profile", {})
    prof = json.loads(data)

    rows = []

    def walk(node, path):
        ch = node.get("children", [])
        m = node.get("metrics", {})
        name = node.get("name", "?")
        if not ch and m:
            rows.append((m.get("rawTime", m.get("time", 0)), name, path))
        for c in ch:
            walk(c, path + "/" + name)

    walk(prof.get("byProgram", prof), "")
    rows.sort(reverse=True)
    tot = sum(r[0] for r in rows)
    print(f"total self-time units: {tot}")
    for t, name, path in rows[:40]:
        print(f"{t/max(tot,1)*100:6.2f}%  {name[:110]}")
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
