"""Run configuration mirroring the reference `dagcon` CLI semantics.

Reference flags (reconstructed from `src/cpp/main.cpp`, SURVEY.md §2 C6):
`-c` min coverage/weight (default 8), `-m` min consensus length (default
500), `-j` worker threads (default 4), `-t` end-trim (default 0). Names and
defaults are preserved so behaviour is comparable; accelerator knobs are
additive.
"""

from __future__ import annotations

import dataclasses
import os


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Persistent compilation cache directory: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> None:
    """Point JAX at the persistent compilation cache (idempotent).

    The devbuild backend compiles one program per shape-ladder
    combination; the cache makes that a one-time cost across processes.
    With JAX_COMPILATION_CACHE_DIR set, JAX already uses that directory
    and no other path is set here."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = compile_cache_dir()
    if jax.config.jax_compilation_cache_dir != path:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@dataclasses.dataclass(frozen=True)
class DagconConfig:
    # Reference-equivalent knobs (dagcon -c / -m / -j / -t).
    min_weight: int = 8
    min_length: int = 500
    threads: int = 4
    trim: int = 0

    # Input format: "m5" (blasr -m 5) or "pre" (HGAP m4topre records).
    fmt: str = "m5"
    # Re-align raw (ungapped) q/t pairs before graph building — the
    # reference `dagcon -a` path over unaligned 'pre' records (SPEC §1.5).
    align: bool = False
    # Where -a alignment runs: "host" (threaded C++ banded DP) or
    # "device" (batched accelerator kernel, ops/align_tpu.py); both are
    # exact.
    align_backend: str = "host"
    # -a scorer: "simple" (SPEC §1.5 linear-gap 1/-2/-3, the default the
    # whole differential stack is pinned to) or "affine" (SPEC §1.6
    # Gotoh). The reference wraps blasr_libcpp's guided affine aligner
    # whose parameters are unreadable (mount empty); the affine option +
    # docs/SCORER_SENSITIVITY.md quantify how much the consensus depends
    # on that choice.
    align_scorer: str = "simple"
    # (match, mismatch, open, extend) for align_scorer="affine"; a gap
    # of length k scores open + (k-1)*extend.
    affine_params: tuple[int, int, int, int] = (1, -2, -4, -1)

    # --- device execution knobs ---
    # Bucket ladders for padded shapes (nodes V, successor window W).
    v_buckets: tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384)
    w_buckets: tuple[int, ...] = (16, 32, 64, 128)
    # Max targets per device batch (per V-bucket batches are formed up to
    # this size before dispatch).
    batch_targets: int = 128
    # Execution backend: "xla" (host graph build + device scan DP),
    # "blocked" (max-plus blocked solve, sqrt(V) depth, guarded exact),
    # "host", "devbuild" (graph build + merge + DP + backtrack all on
    # device, host fallback for flagged targets),
    # "hybrid" (host engine and devbuild pipeline run concurrently on
    # group-aligned chunks with rate-adaptive work stealing), or
    # "auto"; host fallback for out-of-bucket targets always.
    backend: str = "auto"
    # Use the native C++ loader/graph engine when available.
    use_native: bool = True

    # --- transfer knobs ---
    # Cap on any single host->device transfer, in bytes; dispatches are
    # split to stay under it. 0 = the default (1 GiB).
    transfer_cap_bytes: int = 0
    # Feed-chunk size for the streaming loader, in MB (DAGCON_CHUNK_MB
    # env overrides).
    chunk_mb: int = 16
    # Upload graph batches as edge-CSR streams (~10x less transfer; the
    # dense band is scatter-rebuilt on device); DAGCON_EDGE_UPLOAD=1 env
    # also enables.
    edge_upload: bool = False

    def resolved_transfer_cap(self) -> int:
        return self.transfer_cap_bytes if self.transfer_cap_bytes > 0 else 1 << 30

    def __post_init__(self) -> None:
        if self.fmt not in ("m5", "pre"):
            raise ValueError(f"fmt must be 'm5' or 'pre', got {self.fmt!r}")
        if self.align_backend not in ("host", "device"):
            raise ValueError(f"unknown align_backend {self.align_backend!r}")
        if self.align_scorer not in ("simple", "affine"):
            raise ValueError(f"unknown align_scorer {self.align_scorer!r}")
        if self.align_scorer == "affine":
            m, x, o, e = self.affine_params
            if not (m >= 0 and x <= 0 and o <= e <= 0):
                raise ValueError(
                    "affine_params must satisfy match>=0, mismatch<=0, "
                    f"open<=extend<=0; got {self.affine_params}"
                )
            if self.align_backend == "device":
                raise ValueError(
                    "align_backend='device' implements the simple scorer "
                    "only; use align_backend='host' with align_scorer="
                    "'affine'"
                )
        if self.backend not in (
            "auto", "xla", "blocked", "host", "devbuild",
            "hybrid",
        ):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.min_weight < 0 or self.min_length < 0 or self.trim < 0:
            raise ValueError("min_weight/min_length/trim must be >= 0")
