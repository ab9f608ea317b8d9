"""Hit-selection sensitivity experiment (VERDICT r3 #6).

The reference dazcon's `TargetHit` selection (src/cpp/dazcon.cpp,
SURVEY.md §2 C7) decides WHICH overlaps vote in the consensus; its
exact rule is a reconstruction (mount empty). This experiment bounds
the reconstruction risk: it simulates realistic overlap sets (more
hits than the cap, varied read quality and span), runs the full dazcon
pipeline under each candidate policy (`select_hits(policy=...)`) and
several caps, and reports (a) byte-identity of the final FASTA against
the default score-sorted policy and (b) consensus accuracy against the
known true target.

Usage: python tools/hit_selection_sensitivity.py [n_targets]
Writes a markdown table to stdout (pasted into
docs/HIT_SELECTION_SENSITIVITY.md).
"""
import io as _io
import random
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import jax

jax.config.update("jax_platforms", "cpu")

from pbdagcon_tpu.aligner import align_pair
from pbdagcon_tpu.dazcon import run_dazcon
from pbdagcon_tpu.simulate import NoiseProfile, random_seq, sample_read

N = int(sys.argv[1]) if len(sys.argv) > 1 else 24

WORKLOADS = [
    # (name, target_len, n_hits_range, err_range, span_frac_range)
    ("30x-ish full-span, cap binds lightly", 600, (30, 60), (0.02, 0.10),
     (0.85, 1.0)),
    ("deep 100x, cap binds hard", 500, (90, 140), (0.02, 0.12),
     (0.8, 1.0)),
    ("ragged spans, mixed quality", 700, (50, 100), (0.01, 0.15),
     (0.35, 1.0)),
]

VARIANTS = [
    ("score @85 (default)", "score", 85),
    ("length @85", "length", 85),
    ("input @85", "input", 85),
    ("span @85", "span", 85),
    ("score @20", "score", 20),
    ("score @50", "score", 50),
    ("score @1000 (uncapped)", "score", 1000),
]


def simulate_container(seed, n_targets, length, nh_rng, err_rng, span_rng):
    rng = random.Random(seed)
    reads: dict[str, str] = {}
    m4_lines: list[str] = []
    truth: dict[str, str] = {}
    ridx = 0
    for t in range(n_targets):
        tname = f"t{t:03d}"
        tseq = random_seq(rng, length)
        reads[tname] = tseq
        truth[tname] = tseq
        nh = rng.randint(*nh_rng)
        for _ in range(nh):
            err = rng.uniform(*err_rng)
            frac = rng.uniform(*span_rng)
            span = max(50, int(length * frac))
            s = rng.randint(0, max(0, length - span))
            e = s + span
            noise = NoiseProfile(
                sub=err * 0.35, ins=err * 0.4, dele=err * 0.25
            )
            qstr, _ = sample_read(rng, tseq, s, e, noise)
            qseq = qstr.replace("-", "")
            qname = f"r{ridx:05d}"
            ridx += 1
            reads[qname] = qseq
            # blasr-like score: more negative = better; correlated with
            # matched bases but noisy (like a real aligner's score).
            score = -int(2 * span * (1 - err) * rng.uniform(0.9, 1.0))
            m4_lines.append(
                f"{qname} {tname} {score} {100 * (1 - err):.1f} 0 0 "
                f"{len(qseq)} {len(qseq)} 0 {s} {e} {length} 254"
            )
    return reads, m4_lines, truth


def accuracy(fasta: str, truth: dict) -> float:
    by_name: dict[str, str] = {}
    cur = None
    for line in fasta.splitlines():
        if line.startswith(">"):
            cur = line[1:].split("/")[0]
            by_name[cur] = ""
        elif cur:
            by_name[cur] += line
    accs = []
    for t, ref in truth.items():
        seq = by_name.get(t)
        if not seq:
            accs.append(0.0)
            continue
        gq, gt = align_pair(seq, ref)
        m = sum(1 for a, b in zip(gq, gt) if a == b and a != "-")
        accs.append(m / max(1, len(gq)))
    return sum(accs) / max(1, len(accs))


def main() -> None:
    print(f"targets/workload = {N}\n")
    for wi, (wname, length, nh, er, sp) in enumerate(WORKLOADS):
        reads, m4_lines, truth = simulate_container(
            1000 + wi, N, length, nh, er, sp
        )
        text = "\n".join(m4_lines) + "\n"
        print(f"## {wname}\n")
        print("| policy | emitted | byte-identical vs default | "
              "accuracy |")
        print("|---|---|---|---|")
        base = None
        for vname, policy, cap in VARIANTS:
            out = _io.StringIO()
            n = run_dazcon(
                _io.StringIO(text), dict(reads), out,
                min_weight=4, min_length=100, max_hits=cap,
                hit_policy=policy,
            )
            fasta = out.getvalue()
            if base is None:
                base = fasta
            same = "yes" if fasta == base else "no"
            acc = accuracy(fasta, truth)
            print(f"| {vname} | {n} | {same} | {acc * 100:.3f}% |")
        print()


if __name__ == "__main__":
    main()
