"""CSV metric aggregation (reference metric_summ.py:4-38): drop
inf-distance rows, report overall and per-category SR / SPL / distance.

Counterpart of ``benchmarks/metric_summ.py`` without pandas (the card
machine has none): the CSV is read by ``csv`` and averaged by numpy, an
empty cell counting as missing, as pandas' ``mean`` skips NaN.  The
per-category rows come back as a list of dicts, sorted by category as
``groupby`` sorts them.

  python -m bsc_nav_tpu_torch.drivers.metric_summ results.csv
"""

from __future__ import annotations

import csv
import sys

import numpy as np

COLUMNS = ["success", "spl", "distance_to_goal", "object_goal", "id",
           "island", "island_area", "long_memory_query",
           "working_memory_query", "search_point"]
MEANS = (("success_rate", "success"), ("avg_spl", "spl"),
         ("avg_distance_to_goal", "distance_to_goal"))


def _float(cell: str) -> float:
    return float(cell) if cell.strip() else float("nan")


def _mean(values) -> float:
    v = np.asarray(values, np.float64)
    v = v[~np.isnan(v)]
    return float(v.sum() / len(v)) if len(v) else float("nan")


def compute_metrics(csv_file: str, has_header: bool = True):
    with open(csv_file, newline="") as f:
        reader = (csv.DictReader(f) if has_header
                  else csv.DictReader(f, fieldnames=COLUMNS))
        rows = list(reader)
        columns = reader.fieldnames or []
    rows = [r for r in rows if not np.isinf(_float(r["distance_to_goal"]))]

    def means(rs):
        return {k: _mean([_float(r[col]) for r in rs]) for k, col in MEANS}

    overall = {**means(rows), "episodes": len(rows)}
    per_category = None
    if "object_goal" in columns:
        per_category = [{"object_goal": g, **means(
            [r for r in rows if r["object_goal"] == g])}
            for g in sorted({r["object_goal"] for r in rows})]
    return overall, per_category


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    overall, per_category = compute_metrics(argv[0])
    print(f"overall success rate: {overall['success_rate']:.4f}")
    print(f"overall avg SPL:      {overall['avg_spl']:.4f}")
    print(f"overall avg distance: {overall['avg_distance_to_goal']:.4f}")
    if per_category is not None:
        print("\nper-category metrics:")
        for row in per_category:
            print("  " + ", ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))
    return overall


if __name__ == "__main__":
    main()
