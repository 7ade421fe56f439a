#!/usr/bin/env python3
"""Side by side: what ``chip_smoke.py`` printed in several runs, each
labelled (for example a parent's and a change's runs in one call, in the
order parent, change, change, parent).

  python3 scripts/compare_smoke.py parent=p1.log change=c1.log \\
      change=c2.log parent=p2.log [--threshold 3]

Prints, for every kernel row of the runs' ``{"kernels": ...}`` line, its
time in each run and the change of the mean of each label against the
first label's (a row's " (N CTAs)" is dropped from its name, so a change of
geometry keeps it on one line); then, for each of the paper path's 20
bundles, the native and fused (vertical, naive 1:1, planned, measured)
times, their gains, the launch's shared memory and CTAs an SM, per run.  Rows whose means moved by
more than ``--threshold`` percent are marked ``*``.  Reads logs only:
needs no card.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
from pathlib import Path

_CARD = re.compile(
    r"card ms: native ([\d.]+), vfused ([\d.]+) \(([-+\d.]+)%\), naive "
    r"([\d.]+) \(([-+\d.]+)%\), planned ([\d.]+) \(([-+\d.]+)%\), measured "
    r"([\d.]+) \(([-+\d.]+)%\); launch smem (\d+) B, (\d+) CTAs/SM")
_BUNDLE = re.compile(r"^\[paper\] ([\w+]+): plan ")
_CTAS = re.compile(r" \(\d+ CTAs\)")   # a geometry change keeps the row


def parse(text: str) -> tuple[dict[str, float], dict[str, dict]]:
    """(kernel row name -> ms, paper bundle -> its card figures) of one
    chip_smoke log."""
    kernels: dict[str, float] = {}
    bundles: dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        if line.startswith('{"kernels"'):
            kernels = {_CTAS.sub("", r["name"]): r["ms"]
                       for r in json.loads(line)["kernels"]}
            continue
        m = _BUNDLE.match(line)
        if m:
            current = m.group(1)
            continue
        m = _CARD.search(line)
        if m and current:
            v = m.groups()
            bundles[current] = {
                "native": float(v[0]), "vfused": float(v[1]),
                "naive": float(v[3]), "planned": float(v[5]),
                "measured": float(v[7]),
                "gains": tuple(float(v[i]) for i in (2, 4, 6, 8)),
                "smem": int(v[9]), "ctas_per_sm": int(v[10])}
            current = None
    return kernels, bundles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", help="label=path of a chip_smoke log")
    ap.add_argument("--threshold", type=float, default=3.0)
    args = ap.parse_args(argv)
    runs = []
    for item in args.runs:
        label, _, path = item.partition("=")
        runs.append((label, *parse(Path(path).read_text())))
    labels = list(dict.fromkeys(label for label, _k, _b in runs))
    head = " ".join(f"{label:>10}" for label, _k, _b in runs)
    print(f"{'kernel row (ms)':60} {head}  change of the mean vs "
          f"{labels[0]}")
    names = list(dict.fromkeys(n for _l, k, _b in runs for n in k))
    for name in names:
        vals = [k.get(name) for _l, k, _b in runs]
        mean = {lab: statistics.mean(v for (lb, _k, _b), v in
                                     zip(runs, vals) if lb == lab and v)
                for lab in labels
                if any(lb == lab and v for (lb, _k, _b), v in zip(runs, vals))}
        moved = [f"{lab} {mean[lab] / mean[labels[0]] - 1:+.1%}"
                 for lab in labels[1:] if lab in mean and labels[0] in mean]
        mark = "*" if any(abs(float(m.split()[-1][:-1])) > args.threshold
                          for m in moved) else " "
        cells = " ".join(f"{v:10.4f}" if v else f"{'-':>10}" for v in vals)
        print(f"{mark}{name[:59]:59} {cells}  {', '.join(moved)}")
    print()
    print("paper bundle: native / vfused / naive / planned / measured ms "
          "(gains %), smem B, CTAs/SM")
    bnames = list(dict.fromkeys(n for _l, _k, b in runs for n in b))
    for name in bnames:
        print(name)
        for label, _k, b in runs:
            r = b.get(name)
            if r is None:
                print(f"  {label:>8}: -")
                continue
            g = " ".join(f"{x:+.1f}" for x in r["gains"])
            print(f"  {label:>8}: {r['native']:.4f} / {r['vfused']:.4f} / "
                  f"{r['naive']:.4f} / {r['planned']:.4f} / "
                  f"{r['measured']:.4f} ({g}), {r['smem']} B, "
                  f"{r['ctas_per_sm']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
