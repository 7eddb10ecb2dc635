"""Perf-regression gate: BENCH json artifacts against a committed baseline
(port of repro/obs/gate.py).

A baseline document records per-cell metric values with per-kind
tolerances; :func:`compare` lists every way fresh artifacts regress past
them or drop a baselined cell.  The schema tag is the reference's
(``repro/obs/bench-baseline/v1``), so either package reads the other's
baselines.  The port writes no BENCH artifact yet (ROADMAP A8): the
``BENCH_*.json`` files at the repository root are the reference's CPU
artifacts, not the port's baseline.

Metric kinds and their default tolerances:

* ``time``  -- wall-clock (``us_per_step``, ``us_per_request``,
  ``us_per_token``, ``wall_s``, latency ``p50/p95/p99``): relative, default
  1.5 (fresh <= 2.5x baseline).
* ``bytes`` -- resident / transferred bytes: exact by default.
* ``count`` -- fallback / retry / corruption tallies: exact.
* ``rate``  -- hit rates (higher is better): absolute slack, default 0.05.
* ``frac``  -- overhead fractions: absolute slack above, default 0.02.

A cell or metric in the baseline but missing from the fresh artifact is a
finding; fresh cells not in the baseline pass.

    python -m repro_torch.obs.gate seed --out BASELINE.json BENCH_A.json ...
    python -m repro_torch.obs.gate check --baseline BASELINE.json --root DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import Mapping

SCHEMA = "repro/obs/bench-baseline/v1"

#: Default per-kind tolerances (overridable per metric in the baseline).
DEFAULT_TOLERANCES = {
    "time": 1.5,   # relative: fresh <= base * (1 + tol)
    "bytes": 0.0,  # relative: exact by default
    "count": 0.0,  # absolute: exact by default
    "rate": 0.05,  # absolute slack below the baseline (higher is better)
    "frac": 0.02,  # absolute slack above the baseline (lower is better)
}

_TIME_KEYS = {"us_per_step", "us_per_request", "us_per_token", "wall_s",
              "p50", "p95", "p99"}
_BYTES_KEYS = {"embed_bytes_per_step", "packed_bytes",
               "resident_embedding_bytes", "embedding_code_bytes",
               "embedding_scale_bytes"}
_COUNT_KEYS = {"shape_fallbacks", "kernel_fallbacks", "retry_failures",
               "corruption_detected"}
_RATE_KEYS = {"cache_hit_rate"}
_FRAC_KEYS = {"overhead_frac"}


def classify(key: str) -> str | None:
    """Gate kind for a (possibly dotted) metric key; None = not gated."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf in _TIME_KEYS:
        return "time"
    if leaf in _BYTES_KEYS:
        return "bytes"
    if leaf in _COUNT_KEYS:
        return "count"
    if leaf in _RATE_KEYS:
        return "rate"
    if leaf in _FRAC_KEYS:
        return "frac"
    return None


@dataclasses.dataclass(frozen=True)
class GateFinding:
    """One regression (or coverage hole) the gate found."""

    bench: str
    cell: str
    metric: str
    message: str
    baseline: float | None = None
    fresh: float | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# ------------------------------------------------------------------ cells


def _flatten(cell: Mapping, prefix: str = "") -> dict[str, float]:
    """One level of nesting (``latency_us.p95``) flattened to dotted keys."""
    out: dict[str, float] = {}
    for k, v in cell.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix=f"{key}."))
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        else:
            out[key] = float(v)
    return out


def extract_cells(doc: Mapping) -> dict[str, dict[str, float]]:
    """Named cells with their numeric metrics, from any BENCH_* schema.

    Handles the reference's three artifact shapes: a named-cell mapping
    (the end-to-end step bench), cell lists named by scenario / method and
    tier (the serving benches), and section dicts (overhead and chaos
    sections).
    """
    cells: dict[str, dict[str, float]] = {}

    def _name_listed(c: Mapping) -> str:
        scenario = c.get("scenario", "?")
        who = c.get("arch") or c.get("embedding_method", "?")
        name = f"{scenario}/{who}"
        if "bits" in c and c["bits"] != 8:
            name += f"/bits{c['bits']}"
        if c.get("cold_tier"):
            name += "/cold"
        elif c.get("cache_rows"):
            name += f"/hot{c['cache_rows']}"
        elif "cache_rows" in c:
            name += "/uncached"
        return name

    raw = doc.get("cells")
    if isinstance(raw, Mapping):
        for name, cell in raw.items():
            cells[name] = _flatten(cell)
    elif isinstance(raw, list):
        for cell in raw:
            cells[_name_listed(cell)] = _flatten(cell)
    for section in ("lm", "ctr"):
        for cell in doc.get(section, []) or []:
            cells[_name_listed(cell)] = _flatten(cell)
    for section in ("guard_overhead", "obs_overhead", "chaos_serving"):
        cell = doc.get(section)
        if isinstance(cell, Mapping):
            cells[section] = _flatten(cell)
    return cells


# ------------------------------------------------------------------ seed


def seed_baseline(bench_docs: Mapping[str, Mapping],
                  tolerances: Mapping[str, float] | None = None) -> dict:
    """Build a baseline document from {artifact filename: parsed json}."""
    benches: dict = {}
    for fname in sorted(bench_docs):
        cells_out: dict = {}
        for cname, metrics in sorted(extract_cells(bench_docs[fname]).items()):
            gated = {}
            for key, val in sorted(metrics.items()):
                kind = classify(key)
                if kind is None:
                    continue
                gated[key] = {"value": val, "kind": kind}
            if gated:
                cells_out[cname] = gated
        if cells_out:
            benches[fname] = {"cells": cells_out}
    return {
        "schema": SCHEMA,
        "tolerances": dict(tolerances or DEFAULT_TOLERANCES),
        "benches": benches,
    }


# ------------------------------------------------------------------ check


def _allowed(kind: str, base: float, tol: float) -> tuple[float, bool]:
    """(threshold, higher_is_better) for one baselined metric."""
    if kind == "rate":
        return base - tol, True
    if kind in ("count", "frac"):
        return base + tol, False
    return base * (1.0 + tol), False  # time / bytes: relative


def compare(baseline: Mapping,
            fresh_docs: Mapping[str, Mapping]) -> list[GateFinding]:
    """Every way the fresh artifacts regress from (or fail to cover) the
    baseline.  Empty list = gate passes."""
    findings: list[GateFinding] = []
    tols = {**DEFAULT_TOLERANCES, **baseline.get("tolerances", {})}
    for fname, bench in baseline.get("benches", {}).items():
        doc = fresh_docs.get(fname)
        if doc is None:
            findings.append(GateFinding(
                bench=fname, cell="*", metric="*",
                message=f"baselined artifact {fname} is missing",
            ))
            continue
        fresh_cells = extract_cells(doc)
        for cname, metrics in bench.get("cells", {}).items():
            fresh = fresh_cells.get(cname)
            if fresh is None:
                findings.append(GateFinding(
                    bench=fname, cell=cname, metric="*",
                    message="baselined cell is missing from the artifact",
                ))
                continue
            for key, spec in metrics.items():
                base = float(spec["value"])
                kind = spec.get("kind") or classify(key) or "time"
                tol = spec.get("tol", tols.get(kind, 0.0))
                if key not in fresh:
                    findings.append(GateFinding(
                        bench=fname, cell=cname, metric=key, baseline=base,
                        message="baselined metric is missing from the cell",
                    ))
                    continue
                val = fresh[key]
                thresh, higher_better = _allowed(kind, base, tol)
                bad = val < thresh if higher_better else val > thresh
                if bad:
                    direction = "below" if higher_better else "above"
                    findings.append(GateFinding(
                        bench=fname, cell=cname, metric=key,
                        baseline=base, fresh=val,
                        message=(
                            f"{kind} metric regressed: {val:g} is "
                            f"{direction} the allowed {thresh:g} "
                            f"(baseline {base:g}, tol {tol:g})"
                        ),
                    ))
    return findings


def load_baseline(path: str | pathlib.Path) -> dict:
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {doc.get('schema')!r} != {SCHEMA!r}"
        )
    return doc


def load_fresh(root: str | pathlib.Path,
               baseline: Mapping) -> dict[str, dict]:
    """The baselined artifacts found under ``root`` ({filename: doc})."""
    root = pathlib.Path(root)
    out = {}
    for fname in baseline.get("benches", {}):
        p = root / fname
        if p.exists():
            out[fname] = json.loads(p.read_text())
    return out


# ------------------------------------------------------------------ CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.gate",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    seed = sub.add_parser("seed", help="build a baseline from artifacts")
    seed.add_argument("artifacts", nargs="+",
                      help="BENCH_*.json files to baseline")
    seed.add_argument("--out", default="BENCH_BASELINE.json")
    check = sub.add_parser("check", help="compare artifacts to the baseline")
    check.add_argument("--baseline", default="BENCH_BASELINE.json")
    check.add_argument("--root", default=".",
                       help="directory holding the fresh BENCH_*.json files")
    check.add_argument("--report", default=None,
                       help="write the findings as JSON here")
    args = ap.parse_args(argv)

    if args.cmd == "seed":
        docs = {
            pathlib.Path(p).name: json.loads(pathlib.Path(p).read_text())
            for p in args.artifacts
        }
        doc = seed_baseline(docs)
        pathlib.Path(args.out).write_text(json.dumps(doc, indent=2) + "\n")
        n = sum(len(b["cells"]) for b in doc["benches"].values())
        print(f"[obs.gate] seeded {args.out}: {n} cells "
              f"from {len(doc['benches'])} artifacts")
        return 0

    baseline = load_baseline(args.baseline)
    fresh = load_fresh(args.root, baseline)
    findings = compare(baseline, fresh)
    if args.report:
        pathlib.Path(args.report).write_text(json.dumps(
            [f.to_json() for f in findings], indent=2) + "\n")
    for f in findings:
        print(f"[obs.gate] {f.bench} :: {f.cell} :: {f.metric}: {f.message}")
    print(f"[obs.gate] {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
