"""Tensor path: graph linearization + batched device consensus DP.

This package is the accelerator re-architecture of the reference's
`AlnGraphBoost::consensus()` topological DP (`src/cpp/AlnGraphBoost.cpp`,
SURVEY.md §3.4 — reconstructed; mount empty): the merged graph is
linearized host-side into banded dense arrays (SPEC.md §3.1) and the
max-weight-path DP runs on device as a batched reverse max-plus scan
(`dp.py` XLA scan, `dp_blocked.py` max-plus blocked solve), with bit-exact
creation-order backtrack + emission back on the host (`linearize.py`).
"""

from pbdagcon_tpu.ops.linearize import (  # noqa: F401
    LinearGraph,
    backtrack,
    consensus_from_path,
    graph_from_group,
    linearize,
)
