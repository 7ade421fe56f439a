"""The paper's kernel suite planned, fused, run and timed (the port's
counterpart of ``examples/quickstart.py`` and of the library surface the
reference's benchmarks drive).

  PYTHONPATH=src python -m repro_torch.launch.paper                 # quickstart pair
  PYTHONPATH=src python -m repro_torch.launch.paper --pairs --triples \\
      --measure gpu
  PYTHONPATH=src python -m repro_torch.launch.paper --device cpu --small \\
      --triples

With no flag it takes the quickstart's ethash_like + blake_like pair at the
quickstart's sizes; ``--pairs`` the 16 pairs of ``paper_pairs()``,
``--triples`` the 4 triples of ``paper_triples()``, at the reference's
default sizes (``--small``: ``SMALL_KW``).  For each bundle it prints the
plan's members and schedule (``planner.plan``, pairwise as the paper), the
cost model's schedule and predicted gain (``autotuner.search``; a v5e
planning-model figure, not a card time), with ``--measure`` the measured
search's schedule, and the max error of the planned launch against the
plain versions.  On the card it also holds native, vertical fusion
(``generate_vfused``), naive 1:1, the planned and the measured schedule
bitwise against each other, prints their CUDA-event times
(``timing.median_ms``: median of 20, the L2 flushed before each) and gains
over native, the launch's shared memory and its resident CTAs per SM.  Runs on the card unless
``--device cpu`` is given; with no card and no ``--device`` it raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import autotuner, hfuse, planner, timing
from repro_torch.core.cost_model import Schedule
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda
from repro_torch.kernels import paper_suite as ps

# examples/quickstart.py's pair, at its sizes
QUICKSTART = (("ethash_like", dict(R_dag=16384, bm=512)),
              ("blake_like", dict(R=4096, bm=512)))
SEED = 0                        # of the inputs' generator


def run_bundle(named_kw, device: torch.device, *, measure=None,
               flush=None) -> dict:
    """Plan, fuse and run one bundle; ``named_kw`` is ((name, factory
    kwargs), ...).  Returns the bundle's record; on the card, where
    ``flush`` is a ``timing.flush_buffer``, with the variants' times."""
    made = [ps.ALL_KERNELS[n](**kw) for n, kw in named_kw]
    ops = tuple(op for op, _mk, _pf in made)
    names = "+".join(op.name for op in ops)
    plan = planner.plan([planner.GraphOp(op) for op in ops])
    res = autotuner.search(ops)
    res_m = None if measure is None else autotuner.search(ops, measure=measure)

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ins = [t for _op, mk, _pf in made for t in mk(gen, device)]
    runs = {"native": hfuse.run_native(ops),
            "vfused": hfuse.generate_vfused(ops),
            "naive": hfuse.generate(ops, Schedule((1,) * len(ops))),
            "planned": res.build()}
    if res_m is not None:
        runs["measured"] = res_m.build()
    outs = {k: f(*ins) for k, f in runs.items()}
    want = hfuse.run_native(ops, plain=True)(*ins)
    err = max(ps.max_error(g, w, op.member.body)
              for op, g, w in zip(ops, outs["planned"], want))
    bitwise = all(torch.equal(a, b) for k in runs
                  for a, b in zip(outs[k], outs["native"]))
    if not bitwise:
        raise AssertionError(f"{names}: the fused launches differ from "
                             "run_native")
    rec = {"bundle": names, "plan": plan.summary(),
           "schedule": res.best.sched.label(),
           "vmem_cap": res.best.vmem_cap,
           "predicted_gain_pct": res.best.est.speedup_pct(),
           "measured_schedule": None if res_m is None
           else res_m.best.sched.label(),
           "n_measured": None if res_m is None else res_m.n_measured,
           "max_abs_err": err, "bitwise": bitwise}
    if device.type == "cuda":
        ms = {k: timing.median_ms(lambda f=f: f(*ins), flush)
              for k, f in runs.items()}
        smem = max(cuda.member_smem(op.member) for op in ops)
        rec.update(ms=ms, gain_pct={k: 100.0 * (ms["native"] - t)
                                    / ms["native"]
                                    for k, t in ms.items() if k != "native"},
                   smem=smem, ctas_per_sm=cuda.occupancy(smem),
                   ctas={op.name: op.ctas for op in ops})
    return rec


def describe(rec: dict) -> list[str]:
    """The printed lines of one bundle's record."""
    fused = [r for r in rec["plan"] if r["schedule"] != "-"]
    lines = [f"[paper] {rec['bundle']}: plan fuses "
             f"{', '.join(r['members'] + ' (' + r['schedule'] + ')' for r in fused) or 'nothing'}"
             f"; singles {[r['members'] for r in rec['plan'] if r['schedule'] == '-']}",
             f"[paper]   cost-model search: schedule {rec['schedule']}, "
             f"vmem cap {rec['vmem_cap']}, predicted gain "
             f"{rec['predicted_gain_pct']:.2f}% (v5e planning model, not a "
             "card time)"]
    if rec["measured_schedule"] is not None:
        lines.append(f"[paper]   measured search: schedule "
                     f"{rec['measured_schedule']} after {rec['n_measured']} "
                     "measurements")
    lines.append(f"[paper]   planned launch vs plain versions: max|err| "
                 f"{rec['max_abs_err']:.3g}; native, vfused, naive 1:1 and "
                 f"planned{', measured' if rec['measured_schedule'] else ''}"
                 " bitwise equal")
    if "ms" in rec:
        ms, gain = rec["ms"], rec["gain_pct"]
        lines.append("[paper]   card ms: " + ", ".join(
            f"{k} {t:.4f}" + (f" ({gain[k]:+.1f}%)" if k in gain else "")
            for k, t in ms.items())
            + f"; launch smem {rec['smem']} B, {rec['ctas_per_sm']} CTAs/SM,"
            f" member CTAs {rec['ctas']}")
    return lines


def bundles(args) -> list[tuple]:
    """((name, factory kwargs), ...) of each bundle the flags ask for."""
    names = (ps.paper_pairs() if args.pairs else []) + (
        ps.paper_triples() if args.triples else [])
    if not names:
        return [tuple((n, ps.SMALL_KW[n] if args.small else q)
                      for n, q in QUICKSTART)]
    return [tuple((n, ps.SMALL_KW[n] if args.small else {}) for n in b)
            for b in names]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", action="store_true",
                    help="the 16 pairs of paper_pairs()")
    ap.add_argument("--triples", action="store_true",
                    help="the 4 triples of paper_triples()")
    ap.add_argument("--measure", choices=timing.BACKENDS, default=None,
                    help="also search by measurement (gpu: CUDA events; "
                    "interpret: the step-count proxy)")
    ap.add_argument("--small", action="store_true",
                    help="the reference's reduced sizes (SMALL_KW)")
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":            # full fp32 products in the plain versions
        torch.backends.cuda.matmul.allow_tf32 = False
    measure = None if args.measure is None else timing.make_measure(
        args.measure)
    flush = timing.flush_buffer(dev) if dev.type == "cuda" else None
    recs = []
    for named_kw in bundles(args):
        rec = run_bundle(named_kw, dev, measure=measure, flush=flush)
        for line in describe(rec):
            print(line, flush=True)
        recs.append(rec)
    print(f"[paper] {len(recs)} bundles on {dev}")
    return recs


if __name__ == "__main__":
    main()
