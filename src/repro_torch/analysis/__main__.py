"""Static-analysis CLI of the port: ``python -m repro_torch.analysis`` —
lint specs and source, save artifacts, diff reports.

    # lint every registered standard + the hetero composition (CI gate)
    PYTHONPATH=src python -m repro_torch.analysis spec --all

    # one configuration, with overrides and artifacts
    PYTHONPATH=src python -m repro_torch.analysis spec --standard DDR5 \\
        --channels 4 --override nRCD=50 --out lint.json --npz lint.npz

    # heterogeneous composition (same --group syntax as repro_torch.telemetry)
    PYTHONPATH=src python -m repro_torch.analysis spec --group DDR5:2 \\
        --group DDR4:2:80

    # host-sync lint of the port's cycle loop (default: the installed
    # repro_torch tree)
    PYTHONPATH=src python -m repro_torch.analysis trace --out hs.json

    # structural diff: saved reports or standards linted on the fly
    PYTHONPATH=src python -m repro_torch.analysis diff DDR4 DDR5
    PYTHONPATH=src python -m repro_torch.analysis diff before.json after.json

Exit status: 0 when no error-severity findings (``--strict`` also
counts warnings), 1 otherwise.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static DRAM-spec linter + host-sync linter of the "
                    "port.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("spec", help="lint DRAM standards / systems")
    sp.add_argument("--all", action="store_true",
                    help="lint every registered standard plus the "
                         "reference hetero composition")
    sp.add_argument("--standard", default=None)
    sp.add_argument("--org", default=None)
    sp.add_argument("--timing", default=None)
    sp.add_argument("--channels", default=1, type=int)
    sp.add_argument("--group", default=None, action="append",
                    metavar="STD[:CHANNELS[:LINK]]",
                    help="heterogeneous spec group (repeatable); "
                         "overrides --standard")
    sp.add_argument("--override", default=None, action="append",
                    metavar="PARAM=CYCLES",
                    help="timing override (repeatable), e.g. nRCD=50")
    sp.add_argument("--out", default=None, metavar="JSON")
    sp.add_argument("--npz", default=None, metavar="NPZ")
    sp.add_argument("--strict", action="store_true",
                    help="warnings also fail the lint")
    sp.add_argument("--show-info", action="store_true")

    tp = sub.add_parser("trace", help="host-sync lint of the cycle loop")
    tp.add_argument("paths", nargs="*", default=None,
                    help="files/directories (default: the installed "
                         "repro_torch package tree)")
    tp.add_argument("--out", default=None, metavar="JSON")
    tp.add_argument("--npz", default=None, metavar="NPZ")
    tp.add_argument("--strict", action="store_true",
                    help="warnings also fail the lint")
    tp.add_argument("--show-contexts", action="store_true",
                    help="print every discovered hot context")

    dp = sub.add_parser("diff", help="structural diff of two lint runs")
    dp.add_argument("a", help="report path (.json/.npz) or standard name")
    dp.add_argument("b", help="report path (.json/.npz) or standard name")
    dp.add_argument("--show-info", action="store_true")
    return ap


def _parse_overrides(items) -> dict | None:
    if not items:
        return None
    out = {}
    for item in items:
        if "=" not in item:
            raise SystemExit(f"--override expects PARAM=CYCLES, got "
                             f"{item!r}")
        k, v = item.split("=", 1)
        out[k.strip()] = int(v)
    return out


#: reference heterogeneous composition linted by ``spec --all`` — the
#: same native-DDR5 + CXL-attached-DDR4 system the CI hetero smoke runs
HETERO_GROUPS = ("DDR5:2", "DDR4:2:80")


def _parse_group(text: str) -> dict:
    from repro_torch.core.standards import DEFAULT_SYSTEMS
    parts = text.split(":")
    std = parts[0]
    if std not in DEFAULT_SYSTEMS:
        raise SystemExit(f"no default org/timing for {std!r}; known: "
                         f"{sorted(DEFAULT_SYSTEMS)}")
    org, tim = DEFAULT_SYSTEMS[std]
    return dict(standard=std, org_preset=org, timing_preset=tim,
                channels=int(parts[1]) if len(parts) > 1 else 1,
                link_latency=int(parts[2]) if len(parts) > 2 else 0)


def _save(report, out, npz):
    for path, save in ((out, report.save_json), (npz, report.save_npz)):
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            save(path)
            print(f"report written to {path}")


def cmd_spec(args) -> int:
    import repro_torch.core.standards  # noqa: F401  (register all standards)
    from repro_torch.analysis import lint_all, lint_spec, lint_system, merge
    from repro_torch.core.compile import compile_system

    if args.all:
        reports = list(lint_all(channels=args.channels).values())
        msys = compile_system([_parse_group(g) for g in HETERO_GROUPS])
        reports.append(lint_system(msys))
        report = merge(reports, target="all-standards+hetero")
    elif args.group:
        msys = compile_system([_parse_group(g) for g in args.group])
        report = lint_system(msys)
    else:
        std = args.standard or "DDR4"
        report = lint_spec(std, args.org, args.timing,
                           _parse_overrides(args.override),
                           channels=args.channels)
    print(report.summary(show_info=args.show_info))
    _save(report, args.out, args.npz)
    ok = report.ok(strict=args.strict)
    print("spec lint:", "clean" if ok else "FAILED")
    return 0 if ok else 1


def cmd_trace(args) -> int:
    from repro_torch.analysis.tracecheck import lint_paths, package_dir
    report = lint_paths(args.paths or [package_dir()])
    if args.show_contexts:
        for c in report.meta["traced_contexts"]:
            print("context:", c)
    print(report.summary(show_info=True))
    for s in report.meta["suppressions"]:
        print("suppressed:", s)
    print(f"({report.meta['modules']} modules, "
          f"{len(report.meta['traced_contexts'])} hot contexts, "
          f"{len(report.meta['suppressions'])} suppressions)")
    _save(report, args.out, args.npz)
    ok = report.ok(strict=args.strict)
    print("host-sync lint:", "clean" if ok else "FAILED")
    return 0 if ok else 1


def _load_or_lint(ref: str):
    from repro_torch.analysis import LintReport, lint_spec
    if ref.endswith(".json"):
        return LintReport.load_json(ref)
    if ref.endswith(".npz"):
        return LintReport.load_npz(ref)
    import repro_torch.core.standards  # noqa: F401
    return lint_spec(ref)


def cmd_diff(args) -> int:
    from repro_torch.analysis import render_diff
    a, b = _load_or_lint(args.a), _load_or_lint(args.b)
    print(render_diff(a, b))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"spec": cmd_spec, "trace": cmd_trace,
            "diff": cmd_diff}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
