"""Render the §Roofline table from dry-run artifacts (artifacts/dryrun_torch)."""

from __future__ import annotations

import glob
import json
import os

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts", "dryrun_torch")


def load_records(art_dir: str = ART) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        try:
            recs.append(json.load(open(f)))
        except json.JSONDecodeError:
            continue
    return recs


def render_table(recs: list[dict], mesh: str = "pod16x16") -> str:
    rows = []
    header = (
        f"| {'arch':22s} | {'shape':11s} | {'comp_s':>9s} | {'mem_s':>9s} | {'coll_s':>9s} "
        f"| {'bound':10s} | {'useful':>6s} | {'roofline%':>9s} |"
    )
    sep = "|" + "-" * (len(header) - 2) + "|"
    rows.append(header)
    rows.append(sep)
    for r in sorted(recs, key=lambda r: (r.get("arch", ""), r.get("shape", ""))):
        if r.get("mesh") != mesh and r["status"] == "ok":
            continue
        if r["status"] == "skipped":
            if mesh in r["cell"]:
                arch, shape, _ = r["cell"].split("__")
                rows.append(f"| {arch:22s} | {shape:11s} | {'—':>9s} | {'—':>9s} | {'—':>9s} | {'skipped':10s} | {'—':>6s} | {'—':>9s} |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['cell']:22s} | FAILED |")
            continue
        rl = r["roofline"]
        dominant = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        frac = rl["compute_s"] / dominant if dominant else 0.0
        rows.append(
            f"| {r['arch']:22s} | {r['shape']:11s} | {rl['compute_s']:9.3e} | {rl['memory_s']:9.3e} "
            f"| {rl['collective_s']:9.3e} | {rl['bottleneck']:10s} | {rl['useful_ratio']:6.3f} | {100*frac:8.1f}% |"
        )
    return "\n".join(rows)


if __name__ == "__main__":
    recs = load_records()
    for mesh in ("pod16x16", "pod2x16x16"):
        print(f"\n=== mesh {mesh} ===")
        print(render_table(recs, mesh))
