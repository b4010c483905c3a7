"""One run of one benchmark cell.

    python3 -m w2vbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It puts ``src/`` on ``sys.path`` and runs on
the machine it is started on: it exits non-zero, printing no result, when
``torch.cuda`` finds no card or fewer cards than the cell asks for. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers are the last lines of
standard error. A run that finds ``jax``, ``jaxlib``, ``flax``, the JAX
package ``repro`` or the old ``benchmarks`` package loaded once the
window has closed names them on standard error and exits non-zero with no
result.

One option exists for the benchmark's own calibration and is never part
of a cell's run: ``--variant`` plants the control or a fault
(``faults.py``).
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _src_on_path() -> None:
    from w2vbench import manifest

    src = str(manifest.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def execute(workload: str, seed: int, seconds: float, traced: bool, *,
            device: str = "cuda", variant: str = "",
            bench: dict = None, t_start: float = None) -> dict:
    """Run a cell and return ``{"result": <the result line's object>,
    "record": <the traffic driver's record>, "checks": [(name, value,
    limit)]}``.
    ``bench`` replaces ``BENCHMARK.json`` (tests)."""
    _src_on_path()
    from w2vbench import check, faults, manifest

    bench = bench if bench is not None else manifest.load()
    cell = manifest.cell(bench, workload)
    cfg = bench.get("_configs", {}).get(cell["config"]) or \
        manifest.config(bench, cell["config"])
    traffic = bench.get("_traffic", {}).get(cell["traffic"]) or \
        manifest.traffic(cell["traffic"])
    drv = manifest.driver(traffic["kind"])
    with faults.applied(variant):
        rec = drv.run(cell, cfg, traffic, int(seed), float(seconds), traced,
                      T_START if t_start is None else t_start, device=device,
                      variant=variant)
    ok, rows = check.verdict(rec["numbers"], bench.get("_limits", {}).get(
        workload) or check.load_limits(workload))
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, workload, section):
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": _device_name(device), "count": int(cell["chips"]),
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    result = {"correct": bool(ok), "attempted": int(rec["attempted"]),
              "failed": int(rec["failed"]), "metrics": metrics,
              "device": dev}
    tr = rec.get("trace")
    if traced and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return {"result": result, "record": rec, "checks": rows,
            "missing": [m["name"] for m in manifest.metrics_of(
                bench, workload, "end_to_end") if not traced
                and m["name"] not in metrics]}


def _device_name(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)


def _json_safe(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", default="",
                    help="calibration only: the control or a planted fault")
    args = ap.parse_args(argv)

    _src_on_path()
    from w2vbench import manifest

    bench = manifest.load()
    chips = int(manifest.cell(bench, args.workload)["chips"])
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"w2vbench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 3
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  variant=args.variant, bench=bench)
    bad = loaded_forbidden()
    if bad:
        print(f"w2vbench: loaded modules that the port must not load: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 4
    if out["missing"]:
        print(f"w2vbench: no reading of {', '.join(out['missing'])}",
              file=sys.stderr)
        return 5
    rec = out["record"]
    print(f"w2vbench: setup_s {rec['setup_s']:.3f}, window_s "
          f"{rec['window_s']:.3f}, check_s {rec.get('check_s', 0.0):.3f}",
          file=sys.stderr)
    if rec.get("diag"):
        print(f"w2vbench: {json.dumps(_json_safe(rec['diag']))}",
              file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_json_safe(out["result"])), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
