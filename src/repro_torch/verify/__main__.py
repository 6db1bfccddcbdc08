"""Verification-harness CLI of the port (the reference's
``python -m repro.verify``), on the card unless ``--device cpu``.

    # bounded exploration (zero divergences required), smoke matrix
    # ("smoke" is another name of "explore")
    python -m repro_torch.verify explore --standards DDR4 DDR5 HBM3

    # demonstrate counterexample extraction on a miscompiled spec
    python -m repro_torch.verify explore --standard DDR4 --loosen ACT:RD \
        --expect-counterexample --artifact-dir results/verify

    # mutation-sensitivity matrix (100% detection required)
    python -m repro_torch.verify mutate --standards DDR4 DDR5 HBM3

    # differential comparison against pinned fixtures
    python -m repro_torch.verify diff --fixtures tests/verify/fixtures \
        --table results/verify/accuracy.md

Exit status is non-zero whenever the checked property fails, so each
sub-command is CI-gateable on its own.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

from repro_torch.core.controller import ControllerConfig
from repro_torch.core.standards import DEFAULT_SYSTEMS

from .differential import (accuracy_table, diff_against_fixture,
                           write_fixture)
from .explore import explore, loosen_constraint, smoke, tiny_spec
from .mutation import matrix_table, mutation_matrix


def _cmd_explore(args) -> int:
    if args.loosen:
        prev, following = args.loosen.split(":")
        oracle = tiny_spec(args.standard, banks=args.banks, fast=True)
        bad, row = loosen_constraint(oracle, prev, following)
        print(f"loosened constraint row {row}: {prev}->{following} by 1")
        res = explore(bad, oracle=oracle, depth=args.depth,
                      ccfg=ControllerConfig(queue_depth=args.queue_depth),
                      check_tables=False, artifact_dir=args.artifact_dir,
                      standard=args.standard, device=args.device,
                      config_doc=dict(standard=args.standard,
                                      banks=args.banks, rows=8, columns=8,
                                      fast=True))
        print(res)
        cex = res.counterexample
        if args.expect_counterexample:
            if cex is None:
                print("FAIL: loosened spec produced no counterexample")
                return 1
            print(f"minimized path: {list(cex.path)}")
            print(f"divergence: {cex.divergence}")
            print(f"artifact: {cex.artifact}")
            return 0
        return 0 if res.ok else 1

    stds = args.standards or [args.standard]
    results = smoke(standards=stds, max_frontier=args.max_frontier,
                    device=args.device)
    fail = False
    for (std, cfg), res in sorted(results.items()):
        print(f"{cfg:>12}  {res}")
        if not res.ok:
            fail = True
            for d in res.divergences[:3]:
                print(f"              {d}")
            if res.counterexample and args.artifact_dir:
                print(f"              artifact: "
                      f"{res.counterexample.artifact}")
    total_cmds = sum(r.commands_checked for r in results.values())
    total_states = sum(r.states_explored for r in results.values())
    print(f"explored {total_states} states / checked {total_cmds} "
          f"commands across {len(results)} configs: "
          f"{'FAIL' if fail else 'OK'}")
    return 1 if fail else 0


def _cmd_mutate(args) -> int:
    from repro_torch.core.engine import Simulator
    from repro_torch.trace.capture import capture
    stds = args.standards or sorted(DEFAULT_SYSTEMS)
    traces = {}
    for std in stds:
        org, tim = DEFAULT_SYSTEMS[std]
        sim = Simulator(std, org, tim, controller=ControllerConfig(),
                        device=args.device)
        _, dense = sim.run(args.cycles, interval=2.0, read_ratio=0.7,
                           trace=True)
        traces[std] = (sim.cspec, capture(sim.cspec, dense,
                                          controller=sim.controller,
                                          frontend=sim.frontend))
    matrix = mutation_matrix(traces)
    print(matrix_table(matrix))
    missed = {k: v for k, v in matrix.items() if v.startswith("MISSED")}
    print(f"mutation matrix: {len(matrix) - len(missed)}/{len(matrix)} "
          f"detected — {'FAIL' if missed else 'OK (100%)'}")
    return 1 if missed else 0


def _cmd_diff(args) -> int:
    stds = args.standards
    if not stds:
        stds = sorted(os.path.basename(p).rsplit(".", 1)[0]
                      for p in glob.glob(os.path.join(args.fixtures,
                                                      "*.cmdstream")))
    if args.write:
        for std in stds:
            p = write_fixture(std, os.path.join(args.fixtures,
                                                f"{std}.cmdstream"),
                              device=args.device)
            print(f"wrote {p}")
        return 0
    reports = []
    for std in stds:
        r = diff_against_fixture(std, os.path.join(args.fixtures,
                                                   f"{std}.cmdstream"),
                                 device=args.device)
        reports.append(r)
        print(r)
    table = accuracy_table(reports)
    print(table)
    if args.table:
        os.makedirs(os.path.dirname(args.table) or ".", exist_ok=True)
        with open(args.table, "w") as f:
            f.write("# Differential accuracy vs pinned fixtures\n\n"
                    + table + "\n")
        print(f"table -> {args.table}")
    return 0 if all(r.exact for r in reports) else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.verify",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("explore", aliases=["smoke"],
                        help="bounded-depth exploration")
    ex.add_argument("--standard", default="DDR4")
    ex.add_argument("--standards", nargs="*", default=None)
    ex.add_argument("--banks", type=int, default=2)
    ex.add_argument("--depth", type=int, default=12)
    ex.add_argument("--queue-depth", type=int, default=2)
    ex.add_argument("--max-frontier", type=int, default=128)
    ex.add_argument("--loosen", metavar="PREV:NEXT",
                    help="miscompile: loosen this constraint by 1 cycle")
    ex.add_argument("--expect-counterexample", action="store_true")
    ex.add_argument("--artifact-dir", default=None)

    mu = sub.add_parser("mutate", help="audit mutation-sensitivity matrix")
    mu.add_argument("--standards", nargs="*", default=None)
    mu.add_argument("--cycles", type=int, default=3000)

    df = sub.add_parser("diff", help="differential fixture comparison")
    df.add_argument("--fixtures", default="tests/verify/fixtures")
    df.add_argument("--standards", nargs="*", default=None)
    df.add_argument("--write", action="store_true",
                    help="(re)generate fixtures instead of comparing")
    df.add_argument("--table", default=None,
                    help="write the accuracy table to this markdown file")

    for p in (ex, mu, df):
        p.add_argument("--device", default=None,
                       help="torch device of the runs (default: cuda; "
                            "'cpu' runs the plain step)")
    args = ap.parse_args(argv)
    return {"explore": _cmd_explore, "smoke": _cmd_explore,
            "mutate": _cmd_mutate, "diff": _cmd_diff}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
