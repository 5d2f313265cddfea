"""Benchmark reporter, success-rate enrichment tables: the port's copy of
diffbindfr_tpu/app/reporter.py, printing the same text.

Given a results table (rows with complex_name, pose, metrics, scores), the
top-k success rates under the gold cutoffs
    L-RMSD < 2 A, centroid < 1 A, chi1<15deg rate > 0.75, sc-RMSD < 1 A
for each ranking mode (mdn: higher better; mdn_nll, vina: lower better;
oracle: best possible). Plain-text tables, host only.

    python -m diffbindfr_torch.app.reporter results.csv
"""
from __future__ import annotations

import csv

GOLD = {
    "l_rmsd": ("<", 2.0),
    "centroid": ("<", 1.0),
    "chi1_rate": (">", 0.75),
    "sc_rmsd": ("<", 1.0),
}
TOPKS = (1, 3, 5, 10)


def load_results(path: str) -> list:
    with open(path, newline="") as fh:
        rows = []
        for row in csv.DictReader(fh):
            for k, v in row.items():
                if k in ("complex_name", "lig_sdf", "prot_pdb"):
                    continue
                try:
                    row[k] = float(v) if v not in ("", "None") else None
                except ValueError:
                    pass
            rows.append(row)
    return rows


def _passes(row, metric) -> bool | None:
    v = row.get(metric)
    if v is None or not isinstance(v, float):
        return None
    op, cut = GOLD[metric]
    return v < cut if op == "<" else v > cut


def _rank(rows, mode):
    if mode == "mdn":
        key = lambda r: -(r.get("mdn_score") if isinstance(r.get("mdn_score"), float) else -1e30)
    elif mode == "mdn_nll":
        # mean per-contact NLL, lower = better (contact-count-invariant
        # variant of the mdn mode; see mdn_scorer.score_sample_both)
        key = lambda r: r.get("mdn_nll") if isinstance(r.get("mdn_nll"), float) else 1e30
    elif mode == "vina":
        key = lambda r: r.get("vina_score") if isinstance(r.get("vina_score"), float) else 1e30
    elif mode == "oracle":
        key = lambda r: r.get("l_rmsd") if isinstance(r.get("l_rmsd"), float) else 1e30
    else:
        raise ValueError(mode)
    return sorted(rows, key=key)


def success_rates(rows: list, mode: str = "mdn") -> dict:
    """{metric: {topk: rate}} over complexes with that metric available."""
    by_complex: dict = {}
    for r in rows:
        by_complex.setdefault(r["complex_name"], []).append(r)
    out: dict = {}
    for metric in GOLD:
        counts = {k: 0 for k in TOPKS}
        total = 0
        for rows_c in by_complex.values():
            ranked = _rank(rows_c, mode)
            flags = [_passes(r, metric) for r in ranked]
            if all(f is None for f in flags):
                continue
            total += 1
            for k in TOPKS:
                if any(f for f in flags[:k] if f):
                    counts[k] += 1
        if total:
            out[metric] = {k: counts[k] / total for k in TOPKS}
    return out


def format_report(rows: list, modes=None) -> str:
    if modes is None:
        modes = ("mdn", "vina", "oracle")
        if any(isinstance(r.get("mdn_nll"), float) for r in rows):
            modes = ("mdn", "mdn_nll", "vina", "oracle")
    lines = []
    n_complex = len({r["complex_name"] for r in rows})
    lines.append(f"Enrichment report — {n_complex} complexes, {len(rows)} poses")
    for mode in modes:
        rates = success_rates(rows, mode)
        if not rates:
            continue
        lines.append(f"\n[{mode} ranking]")
        header = "metric".ljust(12) + "".join(f"top-{k:<4}" for k in TOPKS)
        lines.append(header)
        lines.append("-" * len(header))
        for metric, r in rates.items():
            lines.append(
                metric.ljust(12)
                + "".join(f"{r[k]*100:5.1f}%  " for k in TOPKS)
            )
    return "\n".join(lines)


def main(argv=None):
    import signal
    import sys

    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # behave under `| head`
    path = (argv or sys.argv[1:])[0]
    print(format_report(load_results(path)))


if __name__ == "__main__":
    main()
