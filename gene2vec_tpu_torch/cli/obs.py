"""Observability CLI: summarize observed run directories — the port of
``gene2vec_tpu/cli/obs.py``.  Host tooling: it reads a run's records and
touches no device.

* ``python -m gene2vec_tpu_torch.cli.obs report <run_dir>`` — render the
  per-phase/throughput/goodput/memory/stall summary of any run directory
  that holds the standard artifacts (``manifest.json`` + ``events.jsonl``,
  written by every trainer's ``run()``);
* ``python -m gene2vec_tpu_torch.cli.obs list <root>`` — find observed run
  directories under a root;
* ``python -m gene2vec_tpu_torch.cli.obs timeline <run_dir> [--out f]`` —
  export every ``timeline.jsonl`` phase record AND ``events.jsonl``
  span record under ``run_dir`` as one Chrome-trace-event JSON,
  loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``;
* ``python -m gene2vec_tpu_torch.cli.obs kernels <run_dir>`` — render the
  kernel cost-attribution records (``kernels.jsonl``, written by
  :mod:`gene2vec_tpu_torch.obs.profiler` when a run enables
  ``kernel_profile``) as a roofline table: the work's flops/bytes, best
  observed wall, achieved-vs-peak utilization and the binding resource
  per kernel (exit 1 when no records exist);
* ``python -m gene2vec_tpu_torch.cli.obs ledger [root]`` — ingest every
  root bench artifact through the per-family adapters
  (:mod:`gene2vec_tpu_torch.obs.ledger`) into the unified ledger;
  ``--out/--csv`` persist it, ``--check`` exits 1 when the
  trailing-window regression rules (this package's ``budgets.json``,
  ``perf.regression``) fire.

* ``python -m gene2vec_tpu_torch.cli.obs trace <run_dir> <trace_id>`` —
  reassemble one distributed trace across every ``events.jsonl`` and
  flight dump under a directory (a fleet's export dir covers the proxy
  and every replica; exit 1 when the trace is absent);
* ``python -m gene2vec_tpu_torch.cli.obs alerts <run_dir>`` — render the
  SLO alert transitions of every ``alerts.jsonl`` under a directory
  (exit 1 when there are none);
* ``python -m gene2vec_tpu_torch.cli.obs incident <bundle>`` — verify
  and render one incident bundle (``<run_dir>/incidents/<ts>_<rule>/``;
  exit 1 when it fails verification).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="obs",
        description="Summarize observed run directories "
                    "(manifest.json + events.jsonl).",
    )
    sub = p.add_subparsers(dest="command", required=True)
    rep = sub.add_parser("report", help="summarize one run directory")
    rep.add_argument("run_dir", help="directory holding events.jsonl / "
                     "manifest.json (e.g. a trainer export dir)")
    rep.add_argument("--json", action="store_true",
                     help="emit the structured summary as JSON instead of "
                     "the human-readable report")
    ls = sub.add_parser("list", help="find observed run dirs under a root")
    ls.add_argument("root", nargs="?", default=".")
    tr = sub.add_parser(
        "trace",
        help="reassemble one distributed trace across every "
             "events.jsonl / flight dump under a directory",
    )
    tr.add_argument("run_dir", help="directory tree to scan (a fleet "
                    "export dir covers the proxy and all replicas)")
    tr.add_argument("trace_id", help="32-hex trace id (from a "
                    "ClientResponse or a flight dump)")
    tr.add_argument("--json", action="store_true",
                    help="emit the reassembled tree as JSON")
    tml = sub.add_parser(
        "timeline",
        help="export timeline.jsonl + events.jsonl under a run dir as "
             "Perfetto-loadable Chrome trace JSON",
    )
    tml.add_argument("run_dir", help="run directory tree to scan")
    tml.add_argument("--out", default=None,
                     help="output path (default <run_dir>/trace.json; "
                     "'-' writes the document to stdout)")
    al = sub.add_parser(
        "alerts",
        help="render the SLO alert transition timeline under a run dir",
    )
    al.add_argument("run_dir", help="directory tree holding alerts.jsonl "
                    "(a fleet run dir, or an export dir covering several)")
    al.add_argument("--json", action="store_true",
                    help="emit the transition records as JSON")
    inc = sub.add_parser(
        "incident",
        help="verify + render one incident bundle "
             "(<run_dir>/incidents/<ts>_<rule>/)",
    )
    inc.add_argument("bundle", help="incident bundle directory")
    inc.add_argument("--json", action="store_true",
                     help="emit the bundle facts as JSON")
    ker = sub.add_parser(
        "kernels",
        help="render the kernel cost-attribution records "
             "(kernels.jsonl) of a run dir as a roofline table",
    )
    ker.add_argument("run_dir", help="run directory holding kernels.jsonl "
                     "(a trainer export dir, or one level above)")
    ker.add_argument("--json", action="store_true",
                     help="emit the kernel records as JSON")
    led = sub.add_parser(
        "ledger",
        help="unified bench ledger over the root bench artifacts",
    )
    led.add_argument("root", nargs="?", default=".",
                     help="directory holding the BENCH_*/MULTICHIP_*/... "
                     "artifacts (default: cwd)")
    led.add_argument("--out", default=None, metavar="JSONL",
                     help="write the ledger records as JSON lines")
    led.add_argument("--csv", default=None, metavar="CSV",
                     help="write the ledger as CSV")
    led.add_argument("--json", action="store_true",
                     help="emit records + regression evaluations as one "
                     "JSON document on stdout")
    led.add_argument("--check", action="store_true",
                     help="run the budgets.json perf.regression rules and "
                     "exit 1 on any detected regression")
    return p


def _ledger(args) -> int:
    from gene2vec_tpu_torch.obs import ledger

    if not os.path.isdir(args.root):
        print(f"obs ledger: {args.root} is not a directory", file=sys.stderr)
        return 2
    records = ledger.ingest_root(args.root)
    evaluations = []
    if args.check or args.json:
        evaluations = ledger.detect_regressions(records, ledger.regression_rules())
    if args.out:
        ledger.write_jsonl(records, args.out)
        print(f"wrote {args.out} ({len(records)} records)", file=sys.stderr)
    if args.csv:
        ledger.write_csv(records, args.csv)
        print(f"wrote {args.csv}", file=sys.stderr)

    regressed = [e for e in evaluations if e.get("regressed")]
    if args.json:
        print(json.dumps(
            {"schema": ledger.SCHEMA, "records": records,
             "regressions": evaluations},
            indent=1, default=str,
        ))
    else:
        fmt = "{:<14} {:<28} {:>5} {:<7} {}"
        print(fmt.format("family", "source", "round", "legacy", "headline"))
        for rec in records:
            headline = rec.get("headline_metric")
            value = (rec.get("metrics") or {}).get(headline)
            shown = (
                f"{headline}={value:g}" if value is not None
                else rec.get("error") or "(no headline)"
            )
            print(fmt.format(
                rec["family"], rec["source"],
                rec["round"] if rec["round"] is not None else "-",
                "legacy" if rec.get("legacy_unstamped") else "",
                shown,
            ))
        for ev in evaluations:
            if ev.get("skipped"):
                continue
            state = "REGRESSED" if ev["regressed"] else "ok"
            print(
                f"regression[{ev['metric']}]: {state} newest "
                f"{ev.get('newest_value')} vs band median "
                f"{ev.get('band_median')} "
                f"(frac {ev.get('regression_frac')}, max "
                f"{ev['max_regression_frac']})"
            )
    if args.check and regressed:
        for ev in regressed:
            print(
                f"obs ledger: REGRESSION {ev['metric']}: newest "
                f"{ev.get('newest_value')} vs band median "
                f"{ev.get('band_median')} exceeds max_regression_frac "
                f"{ev['max_regression_frac']:g}",
                file=sys.stderr,
            )
        return 1
    return 0


def _trace(args) -> int:
    from gene2vec_tpu_torch.obs import flight

    if not os.path.isdir(args.run_dir):
        print(f"obs trace: {args.run_dir} is not a directory", file=sys.stderr)
        return 2
    doc = flight.collect_trace(args.run_dir, args.trace_id)
    if args.json:
        print(json.dumps(doc, indent=1, default=str))
    else:
        print(flight.format_trace(doc))
    # exit 1 when the trace is entirely absent, so scripts can assert
    # "reassembly found something" without parsing
    return 0 if (doc["roots"] or doc["flight"]) else 1


def _alerts(args) -> int:
    from gene2vec_tpu_torch.obs import alerts as alerts_mod

    if not os.path.isdir(args.run_dir):
        print(f"obs alerts: {args.run_dir} is not a directory", file=sys.stderr)
        return 2
    records = alerts_mod.collect_transitions(args.run_dir)
    if args.json:
        print(json.dumps(records, indent=1, default=str))
    else:
        print(alerts_mod.format_timeline(records))
    # exit 1 when no transitions exist (the trace contract)
    return 0 if records else 1


def _incident(args) -> int:
    from gene2vec_tpu_torch.obs import incident as incident_mod

    if not os.path.isdir(args.bundle):
        print(f"obs incident: {args.bundle} is not a directory", file=sys.stderr)
        return 2
    verify = incident_mod.verify_bundle(args.bundle)
    if args.json:
        print(json.dumps({
            "bundle": os.path.abspath(args.bundle),
            "verified": bool(verify),
            "reason": verify.reason,
            "manifest": verify.manifest,
        }, indent=1, default=str))
    else:
        print(incident_mod.format_bundle(args.bundle, verify))
    if not verify:
        print(f"obs incident: bundle failed verification ({verify.reason})",
              file=sys.stderr)
        return 1
    return 0


def _timeline(args) -> int:
    from gene2vec_tpu_torch.obs import timeline as timeline_mod

    if not os.path.isdir(args.run_dir):
        print(f"obs timeline: {args.run_dir} is not a directory", file=sys.stderr)
        return 2
    doc = timeline_mod.collect_run(args.run_dir)
    n = len(doc["traceEvents"])
    if not n:
        print(
            f"obs timeline: no timeline.jsonl/events.jsonl records "
            f"under {args.run_dir}",
            file=sys.stderr,
        )
        return 1
    if args.out == "-":
        json.dump(doc, sys.stdout)
        print()
        return 0
    out = args.out or os.path.join(args.run_dir, "trace.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.write("\n")
    # one machine-readable product line: where the trace went and which
    # phase tracks it contains
    print(json.dumps({
        "out": os.path.abspath(out),
        "trace_events": n,
        "phase_tracks": doc["otherData"]["phase_tracks"],
    }))
    return 0


def _kernels(args) -> int:
    from gene2vec_tpu_torch.obs import profiler

    if not os.path.isdir(args.run_dir):
        print(f"obs kernels: {args.run_dir} is not a directory", file=sys.stderr)
        return 2
    records = profiler.read_kernels(args.run_dir)
    if not records:
        # exit 1 when no attribution exists — scripts assert "the profiler
        # recorded something" without parsing
        print(
            f"obs kernels: no kernels.jsonl records under "
            f"{args.run_dir} (enable kernel_profile / "
            "--kernel-profile on the producing run)",
            file=sys.stderr,
        )
        return 1
    if args.json:
        print(json.dumps(records, indent=1, default=str))
    else:
        print(profiler.format_kernels(records))
    return 0


def _report(args, report) -> int:
    run_dir = args.run_dir
    if not os.path.isdir(run_dir):
        print(f"obs report: {run_dir} is not a directory", file=sys.stderr)
        return 2
    has_artifacts = any(
        os.path.exists(os.path.join(run_dir, f))
        for f in ("events.jsonl", "manifest.json")
    )
    if not has_artifacts:
        nested = report.find_runs(run_dir)
        if len(nested) == 1:
            run_dir = nested[0]
        else:
            print(
                f"obs report: {run_dir} holds no events.jsonl/manifest.json"
                + (f"; candidates:\n  " + "\n  ".join(nested) if nested else ""),
                file=sys.stderr,
            )
            return 2
    if args.json:
        print(json.dumps(report.summarize(run_dir), indent=1, default=str))
    else:
        print(report.format_report(run_dir))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from gene2vec_tpu_torch.obs import report

    if args.command == "list":
        for d in report.find_runs(args.root):
            print(d)
        return 0
    if args.command == "trace":
        return _trace(args)
    if args.command == "alerts":
        return _alerts(args)
    if args.command == "incident":
        return _incident(args)
    if args.command == "timeline":
        return _timeline(args)
    if args.command == "kernels":
        return _kernels(args)
    if args.command == "ledger":
        return _ledger(args)
    return _report(args, report)


if __name__ == "__main__":
    sys.exit(main())
