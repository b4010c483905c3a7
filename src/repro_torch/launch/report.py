"""Render the dry-run JSONL results into the roofline table.

The port's counterpart of ``repro.launch.report``: the same strings from
the same records, so it renders records of either package's dry-run.

    PYTHONPATH=src python -m repro_torch.launch.report results/dryrun.jsonl
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List

from repro_torch.configs.base import cells, get_arch


def load(path: str, tag: str = "baseline") -> Dict:
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if tag and r.get("tag", "baseline") != tag:
                continue
            out[(r["arch"], r["shape"], r["mesh"])] = r   # last write wins
    return out


def fmt_ms(x) -> str:
    return f"{x * 1e3:8.2f}" if x is not None else "     n/a"


def render(results: Dict, mesh: str = "16x16") -> str:
    lines = [
        "| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | bound |"
        " useful_flops | roofline_frac | HBM GB/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape in cells(include_skips=True):
        cfg = get_arch(arch)
        key = (arch, shape, mesh)
        if shape == "long_500k" and not cfg.supports_long_context():
            lines.append(f"| {arch} | {shape} | — | — | — | *skipped:"
                         f" full attention at 500k is quadratic* | — | — | — |")
            continue
        r = results.get(key)
        if r is None or r.get("status") != "ok":
            err = (r or {}).get("error", "missing")[:60]
            lines.append(f"| {arch} | {shape} | ERR | | | {err} | | | |")
            continue
        t = r["roofline"]
        star = "" if r.get("extrapolated", True) else " \\*"
        mem = r["memory_analysis"]
        hbm = (mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
        uf = t.get("useful_flops_frac")
        lines.append(
            f"| {arch} | {shape}{star} |{fmt_ms(t['t_compute'])} |"
            f"{fmt_ms(t['t_memory'])} |{fmt_ms(t['t_collective'])} | "
            f"{t['bottleneck']} | "
            f"{(f'{uf:.3f}' if uf is not None else 'n/a')} | "
            f"{t['roofline_frac']:.3f} | {hbm / 1e9:.1f} |")
    lines.append("")
    lines.append("\\* compile-proof-only record (no loop-corrected cost "
                 "extrapolation): FLOP/collective terms count scan bodies "
                 "once and are unreliable — memory proof and compile "
                 "success stand; see §Dry-run methodology.")
    return "\n".join(lines)


def summarize(results: Dict) -> str:
    ok = [r for r in results.values() if r.get("status") == "ok"]
    err = [r for r in results.values() if r.get("status") != "ok"]
    worst = sorted(ok, key=lambda r: r["roofline"]["roofline_frac"])[:5]
    coll = sorted(ok, key=lambda r: -r["roofline"]["t_collective"])[:5]
    out = [f"cells ok: {len(ok)}, errors: {len(err)}", "",
           "worst roofline_frac:"]
    for r in worst:
        out.append(f"  {r['arch']} × {r['shape']} × {r['mesh']}: "
                   f"{r['roofline']['roofline_frac']:.4f} "
                   f"({r['roofline']['bottleneck']})")
    out.append("most collective-bound:")
    for r in coll:
        out.append(f"  {r['arch']} × {r['shape']} × {r['mesh']}: "
                   f"t_coll {r['roofline']['t_collective'] * 1e3:.0f} ms")
    return "\n".join(out)


if __name__ == "__main__":
    res = load(sys.argv[1])
    mesh = sys.argv[2] if len(sys.argv) > 2 else "16x16"
    print(render(res, mesh))
    print()
    print(summarize(res))
