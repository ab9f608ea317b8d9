"""tpu-dagcon: an accelerator DAG-consensus framework with pbdagcon's capabilities.

Reference: verdurin/pbdagcon (fork of PacificBiosciences/pbdagcon).
The reference mount was empty during development (SURVEY.md caveat); the
normative algorithm spec lives in SPEC.md and is reconstructed from
upstream `src/cpp/Alignment.cpp` / `src/cpp/AlnGraphBoost.cpp`
(reconstructed paths, SURVEY.md section 2).

Layer map (an accelerator re-architecture, not a port):

- `alignment`   : record model, M5/"pre" parsing, gap normalization, trim
                  (Python spec implementation; `native/` holds the C++
                  production loader).
- `oracle`      : exact alignment-graph engine (POA DAG, merge, weighted
                  best-path) — the bit-parity oracle for every other path.
- `ops`         : host linearizer (graph -> fixed-shape tensors) and the
                  device consensus DP (XLA scan, blocked solve).
- `parallel`    : device mesh / sharded batch scheduler / journal.
- `io`          : FASTA writer, streaming M5/pre reader-batcher.
- `native`      : C++ runtime (parser, normalizer, graph engine,
                  linearizer) exposed through ctypes.
"""

__version__ = "0.1.0"

from pbdagcon_tpu.alignment import (  # noqa: F401
    Alignment,
    normalize_gaps,
    parse_m5,
    parse_pre,
    trim_aln,
)
from pbdagcon_tpu.config import DagconConfig  # noqa: F401
