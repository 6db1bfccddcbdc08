"""Differential accuracy comparison against golden command-stream
fixtures.

The upstream Ramulator 2 simulator dumps its issued commands as a plain
text stream — one line per command: issue cycle, command name, then the
address vector down the hierarchy (channel, rank/pseudochannel, ...,
bank, row, column).  This module reads and writes that format so the
port's command streams are held against the reference's golden fixtures
(``tests/verify/fixtures/*.cmdstream``) and re-compared on every PR:
the comparator reports the first diverging command, a per-command-type
count delta, and an aggregate positional match fraction, and
:func:`accuracy_table` renders the result as the markdown table CI
publishes.

Fixtures are deterministic: one canonical (controller, frontend, seed,
n_cycles) configuration per standard, so any engine change that moves
even one command one cycle shows up as a concrete divergence with its
index and both lines printed.
"""
from __future__ import annotations

import dataclasses
import io
import os

import numpy as np
import torch

from repro_torch.core.controller import ControllerConfig
from repro_torch.core.engine import Simulator
from repro_torch.core.standards import DEFAULT_SYSTEMS
from repro_torch.trace.capture import CommandTrace, capture, spec_fingerprint_hex

from .explore import bank_sub

#: canonical fixture run: every knob pinned so the stream is a pure
#: function of the engine + spec
FIXTURE_RUN = dict(n_cycles=1500, interval=2.0, read_ratio=0.7, seed=0x1234)


def golden_run(standard: str, *, n_cycles: int | None = None,
               device: str | torch.device | None = None):
    """The canonical fixture configuration for one standard, run by the
    port's ``Simulator`` on ``device`` (``None`` = CUDA)."""
    org, tim = DEFAULT_SYSTEMS[standard]
    sim = Simulator(standard, org, tim, controller=ControllerConfig(),
                    device=device)
    run = dict(FIXTURE_RUN)
    if n_cycles is not None:
        run["n_cycles"] = n_cycles
    _, dense = sim.run(run["n_cycles"], interval=run["interval"],
                       read_ratio=run["read_ratio"], trace=True,
                       seed=run["seed"])
    tr = capture(sim.cspec, dense, controller=sim.controller,
                 frontend=sim.frontend)
    return sim.cspec, tr


# ---------------------------------------------------------------------------
# The upstream-style text format
# ---------------------------------------------------------------------------

def dump_cmd_stream(cspec, tr: CommandTrace, path: str | None = None) -> str:
    """Render a captured trace as an upstream-style command dump."""
    out = io.StringIO()
    out.write("# ramulator2-style command stream\n")
    out.write(f"# standard={cspec.standard} org={cspec.org_preset} "
              f"timing={cspec.timing_preset}\n")
    out.write(f"# n_cycles={tr.n_cycles} "
              f"fingerprint={spec_fingerprint_hex(cspec)}\n")
    out.write("# clk cmd " +
              " ".join(lv.lower() for lv in cspec.levels) + " row col\n")
    chan = np.zeros(len(tr.clk), np.int64) if tr.chan is None else tr.chan
    for i in range(len(tr.clk)):
        sub = bank_sub(cspec, int(tr.bank[i]))
        fields = [int(chan[i])] + [int(v) for v in sub]
        out.write(f"{int(tr.clk[i])} {tr.cmd_names[int(tr.cmd[i])]} "
                  + " ".join(str(v) for v in fields)
                  + f" {int(tr.row[i])} 0\n")
    text = out.getvalue()
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    return text


def parse_cmd_stream(source: str) -> dict:
    """Parse a command dump (path or literal text) into columns:
    ``{"meta": {...}, "clk": [...], "cmd": [...], "addr": [[...], ...]}``
    where each addr vector is ``[channel, ..., bank, row, col]``."""
    if "\n" not in source and os.path.exists(source):
        with open(source) as f:
            text = f.read()
    else:
        text = source
    meta, clk, cmd, addr = {}, [], [], []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            for tok in line[1:].split():
                if "=" in tok:
                    k, v = tok.split("=", 1)
                    meta[k] = v
            continue
        parts = line.split()
        clk.append(int(parts[0]))
        cmd.append(parts[1])
        addr.append([int(x) for x in parts[2:]])
    return {"meta": meta, "clk": clk, "cmd": cmd, "addr": addr}


def _rows_of(parsed: dict) -> list[tuple]:
    return [(c, n, tuple(a))
            for c, n, a in zip(parsed["clk"], parsed["cmd"], parsed["addr"])]


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DiffReport:
    standard: str
    n_golden: int
    n_current: int
    first_divergence: int          # row index, -1 when streams agree
    match_fraction: float          # positional matches over max length
    per_cmd: dict                  # name -> (golden_count, current_count)
    divergence_detail: str = ""

    @property
    def exact(self) -> bool:
        return self.first_divergence < 0 and self.n_golden == self.n_current

    def __str__(self):
        if self.exact:
            return (f"diff[{self.standard}]: exact match "
                    f"({self.n_golden} commands)")
        return (f"diff[{self.standard}]: diverges at row "
                f"{self.first_divergence} "
                f"(match {self.match_fraction:.4f}) "
                f"{self.divergence_detail}")


def compare_streams(standard: str, golden: dict, current: dict) -> DiffReport:
    g, c = _rows_of(golden), _rows_of(current)
    n = min(len(g), len(c))
    first, detail = -1, ""
    for i in range(n):
        if g[i] != c[i]:
            first, detail = i, f"golden={g[i]} current={c[i]}"
            break
    if first < 0 and len(g) != len(c):
        first = n
        detail = (f"length mismatch: golden={len(g)} current={len(c)}")
    matches = sum(1 for i in range(n) if g[i] == c[i])
    per_cmd = {}
    for name in sorted({r[1] for r in g} | {r[1] for r in c}):
        per_cmd[name] = (sum(1 for r in g if r[1] == name),
                         sum(1 for r in c if r[1] == name))
    return DiffReport(standard=standard, n_golden=len(g), n_current=len(c),
                      first_divergence=first,
                      match_fraction=matches / max(len(g), len(c), 1),
                      per_cmd=per_cmd, divergence_detail=detail)


def diff_against_fixture(standard: str, fixture_path: str, *,
                         device: str | torch.device | None = None
                         ) -> DiffReport:
    """Re-run the canonical config and compare to the pinned fixture."""
    golden = parse_cmd_stream(fixture_path)
    cspec, tr = golden_run(standard, device=device)
    current = parse_cmd_stream(dump_cmd_stream(cspec, tr))
    return compare_streams(standard, golden, current)


def write_fixture(standard: str, fixture_path: str, *,
                  device: str | torch.device | None = None) -> str:
    cspec, tr = golden_run(standard, device=device)
    dump_cmd_stream(cspec, tr, fixture_path)
    return fixture_path


def accuracy_table(reports: list[DiffReport]) -> str:
    """The accuracy table CI publishes: per-standard positional match
    fraction plus command-count deltas."""
    lines = ["| standard | commands (golden/current) | match | "
             "first divergence | cmd-count deltas |",
             "|---|---|---|---|---|"]
    for r in sorted(reports, key=lambda r: r.standard):
        deltas = ", ".join(f"{k}:{g}->{c}"
                           for k, (g, c) in r.per_cmd.items() if g != c)
        lines.append(
            f"| {r.standard} | {r.n_golden}/{r.n_current} "
            f"| {r.match_fraction:.4f} "
            f"| {'-' if r.first_divergence < 0 else r.first_divergence} "
            f"| {deltas or '-'} |")
    return "\n".join(lines)
