"""Device DP solvers (`dp._solve`: the sequential scan and the blocked
max-plus solve) against each other and the host DP, and the rules that
pick between them. Scores must be bitwise identical. The `gpu` tests
run the same checks compiled for the card."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from pbdagcon_tpu.alignment import normalize_gaps
from pbdagcon_tpu.oracle.graph import AlnGraph
from pbdagcon_tpu.ops.dp import (
    DP_KEYS, _solve, batch_scores, choose_layout, dp_scores, pad_batch,
)
from pbdagcon_tpu.ops.linearize import backtrack, host_scores, linearize
from pbdagcon_tpu.simulate import NoiseProfile, simulate_pileup

SOLVERS = ("scan", "blocked")


def _lins(seeds, length=150, cov=20, noise=None):
    out = []
    for seed in seeds:
        rng = random.Random(seed)
        backbone, alns = simulate_pileup(
            rng, f"p{seed}", length, cov, noise or NoiseProfile()
        )
        g = AlnGraph(backbone)
        for a in alns:
            g.add_aln(normalize_gaps(a))
        g.merge_nodes()
        out.append(linearize(g, sid=f"p{seed}"))
    return out


def _v_bucket(lins):
    need = max(l.n for l in lins)
    for v in (64, 128, 256, 512, 1024, 2048, 4096):
        if need <= v:
            return v
    raise ValueError(need)


def _solver_scores(lins, V, W, K, solver):
    batch = pad_batch(lins, V, W, K)
    s, unconv = _solve(tuple(jnp.asarray(batch[k]) for k in DP_KEYS), V,
                       solver)
    assert unconv is None or not np.asarray(unconv).any()
    return np.asarray(s)


def _check_matches_xla_and_host(solver):
    lins = _lins(range(4))
    V = _v_bucket(lins)
    W, K = choose_layout(lins)
    xla = batch_scores(lins, V, W, K, backend="xla")
    got = _solver_scores(lins, V, W, K, solver)
    for i, lin in enumerate(lins):
        hs = host_scores(lin)
        np.testing.assert_array_equal(xla[i, : lin.n], hs)
        np.testing.assert_array_equal(got[i, : lin.n], hs)
        assert backtrack(lin, got[i, : lin.n]) == backtrack(lin, hs)


def _check_high_depth_long_edges(solver):
    lins = _lins(
        [50, 51], length=100, cov=80,
        noise=NoiseProfile(sub=0.04, ins=0.18, dele=0.09, max_ins_run=4),
    )
    V = _v_bucket(lins)
    W, K = choose_layout(lins)
    assert K >= 8  # the point of this case: long edges present
    got = _solver_scores(lins, V, W, K, solver)
    for i, lin in enumerate(lins):
        np.testing.assert_array_equal(got[i, : lin.n], host_scores(lin))


def _check_nonmultiple_batch(solver):
    """A batch of 3 targets (no padding rows) comes back as 3 rows."""
    lins = _lins([60, 61, 62], length=80, cov=10)
    V = _v_bucket(lins)
    W, K = choose_layout(lins)
    got = _solver_scores(lins, V, W, K, solver)
    assert got.shape[0] == 3
    for i, lin in enumerate(lins):
        np.testing.assert_array_equal(got[i, : lin.n], host_scores(lin))


@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_matches_xla_and_host(solver):
    _check_matches_xla_and_host(solver)


@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_high_depth_long_edges(solver):
    _check_high_depth_long_edges(solver)


@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_nonmultiple_batch(solver):
    _check_nonmultiple_batch(solver)


def _random_batch(seed, B, V, W, K):
    """Dense random DP batch: band edges, unsupported nodes, exit edges
    and a few long edges (u < w)."""
    rng = np.random.default_rng(seed)
    win = np.where(
        rng.random((B, V, W)) < 0.2, rng.integers(0, 40, (B, V, W)), -1
    ).astype(np.int16)
    exit_c = np.where(
        rng.random((B, V)) < 0.05, rng.integers(0, 9, (B, V)), -1
    ).astype(np.int16)
    cov = rng.integers(0, 60, (B, V)).astype(np.int16)
    unsup = rng.random((B, V)) < 0.1
    lu = np.full((B, K), -1, np.int32)
    lw = np.full((B, K), -1, np.int32)
    le = np.full((B, K), -np.inf, np.float32)
    nl = min(K, 3)
    lu[:, :nl] = rng.integers(0, V // 2, (B, nl))
    lw[:, :nl] = lu[:, :nl] + W + 1 + rng.integers(0, V // 2 - W - 1, (B, nl))
    le[:, :nl] = rng.integers(-20, 20, (B, nl)) * 0.5
    return [jnp.asarray(x) for x in (win, exit_c, cov, unsup, lu, lw, le)]


@pytest.mark.parametrize("W", [48, 96, 5])
def test_blocked_nonpow2_band_width(W):
    """Band widths that are not a power of two (the devbuild W rungs 48
    and 96) solve bitwise equal to the scan through the blocked form."""
    V = -(-(3 * W + 7) // 64) * 64
    args = _random_batch(W, B=2, V=V, W=W, K=5)
    ref = np.asarray(dp_scores(*args))
    got, unconv = _solve(args, V, "blocked")
    assert not np.asarray(unconv).any()
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_pallas_backend_rejected():
    """There is no hand-written DP kernel backend: the config and the CLI
    refuse `pallas`."""
    from pbdagcon_tpu.cli import build_parser
    from pbdagcon_tpu.config import DagconConfig

    with pytest.raises(ValueError, match="unknown backend"):
        DagconConfig(backend="pallas")
    with pytest.raises(SystemExit):
        build_parser().parse_args(["in.m5", "--backend", "pallas"])


def _check_routing():
    """Devbuild takes the blocked solve for narrow bands and the scan
    for wide ones; the xla path's arena rule likewise."""
    from pbdagcon_tpu.devpipe import DevCapsConfig, caps_for, dp_route
    from pbdagcon_tpu.ops.dp import arena_solver

    narrow = caps_for(8, 32, 512, 256, DevCapsConfig(), w_need=32)
    wide = caps_for(8, 32, 512, 256, DevCapsConfig(), w_need=64)
    assert dp_route(narrow) == "blocked"
    assert dp_route(wide) == "scan"
    V = 512
    for W, want in ((16, "blocked"), (64, "scan")):
        batch = {
            "win_count": np.zeros((8, V, W), np.int16),
            "cov": np.full((8, V), 30, np.int16),
        }
        assert arena_solver(batch, V) == want


def test_solver_routing():
    _check_routing()


@pytest.mark.gpu
def test_solver_routing_on_gpu(gpu):
    """The card takes the same routing rule as the CPU."""
    _check_routing()


@pytest.mark.gpu
@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_compiled_matches_xla_and_host(gpu, solver):
    _check_matches_xla_and_host(solver)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_compiled_high_depth_long_edges(gpu, solver):
    _check_high_depth_long_edges(solver)
