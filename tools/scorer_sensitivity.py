"""Scorer-sensitivity experiment (VERDICT r1 item #9).

The reference's -a path scores re-alignments with blasr_libcpp's guided
affine aligner; its parameters are unreadable (reference mount empty).
This experiment measures how much the *consensus output* depends on the
re-alignment scorer: it runs the full -a pipeline over realistic
simulated pileups under the SPEC §1.5 simple scorer and a sweep of
§1.6 affine parameterizations, then reports (a) how often the final
FASTA is identical across scorers and (b) consensus accuracy against
the known true backbone under each scorer.

Usage: python tools/scorer_sensitivity.py [n_targets_per_workload]
Writes a markdown table to stdout (pasted into
docs/SCORER_SENSITIVITY.md).
"""
import io as _io
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import jax

jax.config.update("jax_platforms", "cpu")

from pbdagcon_tpu.aligner import align_pair
from pbdagcon_tpu.config import DagconConfig
from pbdagcon_tpu.io import FastaWriter
from pbdagcon_tpu.pipeline import run_stream
from pbdagcon_tpu.simulate import NoiseProfile, simulate_targets, to_pre_raw

N = int(sys.argv[1]) if len(sys.argv) > 1 else 48

WORKLOADS = [
    ("pacbio-like 1000bp x 30x", 1000, 30, NoiseProfile()),
    ("low-cov 1000bp x 10x", 1000, 10, NoiseProfile()),
    ("high-depth 500bp x 60x", 500, 60, NoiseProfile()),
    (
        "gap-heavy 1000bp x 30x",
        1000,
        30,
        NoiseProfile(sub=0.05, ins=0.2, dele=0.1),
    ),
]

SCORERS = [
    ("simple 1/-2/-3 (SPEC 1.5)", "simple", (1, -2, -4, -1)),
    ("affine 1/-2/-4/-1", "affine", (1, -2, -4, -1)),
    ("affine 1/-3/-5/-2", "affine", (1, -3, -5, -2)),
    ("affine 2/-4/-6/-1", "affine", (2, -4, -6, -1)),
    ("affine 1/-2/-3/-3 (linear-equiv)", "affine", (1, -2, -3, -3)),
]


def fasta_by_sid(fasta: str) -> dict[str, list[tuple[int, int, str]]]:
    """sid -> [(start, end, seq)] fragments, ranges from the headers
    (`>{sid}/{start}_{end}`, SPEC §2.7)."""
    out: dict[str, list[tuple[int, int, str]]] = {}
    cur = None
    for line in fasta.splitlines():
        if line.startswith(">"):
            head = line[1:]
            sid, _, rng = head.partition("/")
            if "_" in rng:
                s, _, e = rng.partition("_")
                start, end = int(s), int(e)
            else:
                start, end = 0, 1 << 30
            cur = (sid, start, end)
            out.setdefault(sid, []).append((start, end, ""))
        elif cur is not None:
            sid = cur[0]
            s, e, seq = out[sid][-1]
            out[sid][-1] = (s, e, seq + line)
    return out


def identity(frags: list[tuple[int, int, str]], truth: str) -> float:
    """Mean per-fragment identity against the covered backbone range
    (uncovered ends are a min-coverage property, not a scorer one)."""
    if not frags:
        return 0.0
    tot_match = tot_cols = 0
    for start, end, seq in frags:
        ref = truth[start : min(end, len(truth))]
        gq, gt = align_pair(seq, ref)
        tot_match += sum(1 for a, b in zip(gq, gt) if a == b and a != "-")
        tot_cols += len(gq)
    return tot_match / max(1, tot_cols)


def main() -> None:
    print(f"targets/workload = {N}\n")
    for wname, length, cov, noise in WORKLOADS:
        lines = []
        truth: dict[str, str] = {}
        for tid, bb, alns in simulate_targets(777, N, length, cov, noise):
            truth[tid] = bb
            lines.extend(to_pre_raw(a) for a in alns)
        text = "\n".join(lines) + "\n"
        results = []
        base_fasta = None
        for sname, scorer, params in SCORERS:
            cfg = DagconConfig(
                fmt="pre", align=True, align_scorer=scorer,
                affine_params=params, min_weight=max(2, cov // 4),
                min_length=100, backend="host", use_native=True,
                threads=4,
            )
            buf = _io.StringIO()
            run_stream(_io.StringIO(text), FastaWriter(buf), cfg)
            fasta = buf.getvalue()
            by_sid = fasta_by_sid(fasta)
            accs = [identity(by_sid.get(t, []), bb) for t, bb in truth.items()]
            acc = sum(accs) / len(accs)
            if base_fasta is None:
                base_fasta = fasta
                base_by_sid = by_sid
                ident = 1.0
                ident_bytes = True
            else:
                same = sum(
                    1 for t in truth
                    if by_sid.get(t, "") == base_by_sid.get(t, "")
                )
                ident = same / len(truth)
                ident_bytes = fasta == base_fasta
            results.append((sname, acc, ident, ident_bytes))
        print(f"## {wname}\n")
        print("| scorer | consensus accuracy | targets identical to simple |")
        print("|---|---|---|")
        for sname, acc, ident, _ib in results:
            print(f"| {sname} | {acc*100:.4f}% | {ident*100:.1f}% |")
        print()


if __name__ == "__main__":
    main()
