"""The top device kernels of a ``torch.profiler`` Chrome trace, by summed
duration.  Counterpart of ``scripts/summarize_trace.py``.

    python -m opadpo_torch.tools.summarize_trace DIR [N]

It takes the newest ``*.json`` or ``*.json.gz`` trace under DIR (searched
recursively; a file path is taken as it is), keeps the complete events of
category ``kernel`` (the device's; the host's operator, runtime and Python
rows are skipped), groups them by name and prints the top N (40) by summed
duration with their counts and shares.  A trace with no device kernel (one
taken on the CPU) falls back to its host operators (category ``cpu_op``),
as the JAX script falls back to every op, and says so.  Names are
compared within one trace only.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def newest_trace(root: str) -> str:
    """The newest ``*.json`` / ``*.json.gz`` under ``root`` (or ``root``
    itself when it is a file)."""
    if os.path.isfile(root):
        return root
    paths = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(root, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {root}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def summarize(root: str, top_n: int = 40) -> dict:
    """-> {"path", "device" (whether device kernels were found),
    "total_us", "distinct", "top": [{"name", "us", "count", "share"}]}."""
    path = newest_trace(root)
    events = [e for e in load_events(path)
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") == "kernel"]
    picked = ([e for e in events if e.get("cat") in DEVICE_CATEGORIES]
              if device else
              [e for e in events if e.get("cat") == "cpu_op"] or events)
    dur, cnt = collections.Counter(), collections.Counter()
    for e in picked:
        dur[e["name"]] += float(e["dur"])
        cnt[e["name"]] += 1
    total = sum(dur.values())
    return {"path": path, "device": bool(device), "total_us": total,
            "distinct": len(dur),
            "top": [{"name": name, "us": d, "count": cnt[name],
                     "share": d / total if total else 0.0}
                    for name, d in dur.most_common(top_n)]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    res = summarize(argv[0], int(argv[1]) if len(argv) > 1 else 40)
    what = "device-kernel" if res["device"] else \
        "event (no device kernel in this trace)"
    print(f"{res['path']}\ntotal {what} time: {res['total_us'] / 1e3:.2f} ms "
          f"({res['distinct']} distinct)\n")
    print(f"{'us total':>12} {'%':>6} {'count':>7}  name")
    for row in res["top"]:
        print(f"{row['us']:>12.1f} {100 * row['share']:>6.2f} "
              f"{row['count']:>7}  {row['name'][:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
