"""CLI: ``python -m repro_torch.analysis [--quick] [--device cuda|cpu]
[--gates G1,G2] [--out report.json] [--json]``.

Exit status 0 iff every gate passed. ``--quick`` runs the gates that
need no device (carry budget, dtype policy, telemetry off, lint: shapes
on the ``meta`` device, a tiny eager run on the CPU, an AST scan). The
device gates -- the grid's launches and forms, the SASS scan -- run on
``--device`` (CUDA by default; it raises without a card, and
``--device cpu`` runs the grid through the eager loops, the SASS scan
then reporting that it did not run)."""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.report import DEVICE_GATES, GATES, run_gates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="invariant gates of the port's scheduling engines "
                    "(see docs/analysis_torch.md)")
    ap.add_argument("--out", metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--gates", metavar="G1,G2",
                    help=f"subset of {','.join(GATES)}")
    ap.add_argument("--quick", action="store_true",
                    help="leave out the device gates "
                         f"({', '.join(DEVICE_GATES)})")
    ap.add_argument("--device", default=None,
                    help="where the device gates run (default: cuda)")
    ap.add_argument("--json", action="store_true",
                    help="print the full report to stdout")
    args = ap.parse_args(argv)

    gates = list(GATES)
    if args.gates:
        gates = [g.strip() for g in args.gates.split(",") if g.strip()]
    if args.quick:
        gates = [g for g in gates if g not in DEVICE_GATES]
    device = None
    if set(gates) & set(DEVICE_GATES):
        from repro_torch.utils.device import resolve_device
        device = resolve_device(args.device)

    report = run_gates(gates=gates, device=device,
                       log=lambda msg: print(f"[analysis] {msg}",
                                             file=sys.stderr))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True, default=str)
    if args.json:
        json.dump(report, sys.stdout, indent=2, sort_keys=True, default=str)
        print()
    for name, gate in report["gates"].items():
        status = ("OK" if gate["passed"] else "FAIL") + (
            "" if gate.get("run", True) else " (not run)")
        print(f"{name:18s} {status}")
        for p in gate["problems"]:
            print(f"  - {p}", file=sys.stderr)
    print(f"analysis: {'OK' if report['passed'] else 'FAIL'} "
          f"({report['wall_s']}s)")
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
