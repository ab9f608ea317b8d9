"""Execute-only devbuild rate vs batch size B (resident inputs, one jit
chain, scalar fetch): does a bigger batch amortize per-op dispatch
overheads on the chip?

    python tools/prof_batchsize.py [B ...]
"""
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main() -> int:
    bs = [int(a) for a in sys.argv[1:]] or [128, 256]
    length, cov = 1000, 30

    import jax
    import jax.numpy as jnp

    from pbdagcon_tpu import native
    from pbdagcon_tpu.devpipe import (
        DevCapsConfig, _C_LADDER, _L_LADDER, _R_LADDER,
        _ladder, caps_for, ins_cap,
    )
    from pbdagcon_tpu.ops import devemit
    from pbdagcon_tpu.ops.devbuild_jax import device_build
    from pbdagcon_tpu.ops.dp import dp_scores
    from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

    print(f"platform={jax.devices()[0].platform}", file=sys.stderr)
    assert native.ensure_built()
    n_targets = max(bs)
    lines = []
    for _tid, _bb, alns in simulate_targets(
        1234, n_targets, length, cov, NoiseProfile()
    ):
        lines.extend(to_pre_raw(a) for a in alns)
    text = ("\n".join(lines) + "\n").encode()
    eng = native.NativeEngine(
        min_weight=max(2, cov // 4), min_length=100, threads=4, align=True
    )
    count = eng.encode_text(text, fmt="pre", flush=True)
    metas = eng.enc_metas(count)
    for B in bs:
        caps = caps_for(
            B,
            _ladder(int(metas[:, 0].max()), _R_LADDER),
            _ladder(int(metas[:, 1].max()), _C_LADDER),
            _ladder(int(metas[:, 2].max()), _L_LADDER),
            DevCapsConfig.heavy(),
            ch_need=int(metas[:, 5].max()),
            sm_need=int(metas[:, 6].max()),
            nd_need=int(metas[:, 3].max()),
            dq_need=int(metas[:, 7].max()),
            se_need=int(metas[:, 8].max()),
            w_need=64,
        )
        NI = ins_cap(caps)
        part = [i for i in range(count) if int(metas[i, 3]) <= NI][:B]
        arrs = eng.enc_fill(part, caps.R, caps.C, caps.L, NI, B=B)
        dev_in = tuple(jax.device_put(np.asarray(a)) for a in arrs)
        jax.block_until_ready(dev_in[0])
        Pw = min(caps.V, 2 * caps.L + 64)
        KREP = 3

        @jax.jit
        def _chain(ops_, starts_, bbuf_, ins_, Lr_):
            tot = jnp.int32(0)
            o = ops_
            for _ in range(KREP):
                b = device_build(o, starts_, bbuf_, ins_, Lr_, caps)
                s = dp_scores(
                    b["win"], b["exit_cnt"], b["cov"], b["unsup"],
                    b["long_u"], b["long_w"], b["long_esc"],
                )
                e = devemit.backtrack_emit(b, s, jnp.int32(7), Pw)
                pl = jnp.sum(e["path_len"]).astype(jnp.int32)
                tot = tot + pl
                o = o ^ jnp.equal(pl, -1234567).astype(o.dtype)
            return tot

        t0 = time.time()
        _chain(*dev_in).block_until_ready()
        t_compile = time.time() - t0
        times = []
        for _ in range(3):
            t0 = time.time()
            _chain(*dev_in).block_until_ready()
            times.append((time.time() - t0) / KREP)
        dt = sorted(times)[1]
        bases = B * length
        print(
            f"B={B}: {dt*1000:.0f} ms/step = {bases/dt:,.0f} b/s execute"
            f" (compile {t_compile:.0f}s, runs"
            f" {' '.join(f'{x*1000:.0f}' for x in times)})",
            file=sys.stderr, flush=True,
        )
    eng.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
