"""Trace artifacts: the ``.npz`` round trip and the JSON Lines export, in
the reference's format (``repro.trace.format``), so an artifact written
by either package loads in the other.

One ``.npz`` file holds the whole artifact: the int32 columns plus the
JSON-encoded metadata (spec provenance, resolved timings, fingerprint,
run configuration).  ``save``/``load`` round-trip exactly.  The JSON Lines
export streams one record per issued command after a header line with
the metadata; :func:`iter_records` is the shared record iterator.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.trace.capture import FIELDS, CommandTrace, system_from_meta

#: v2 added the ``chan`` column, v3 the ``group`` column; v1/v2 artifacts
#: load with all-zero channel and group columns
_FORMAT_VERSION = 3


def save(trace: CommandTrace, path: str) -> str:
    """Write one self-contained ``.npz`` trace artifact; returns its
    path (``.npz`` appended when missing)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(
        path,
        __version__=np.int32(_FORMAT_VERSION),
        n_cycles=np.int64(trace.n_cycles),
        cmd_names=np.array(trace.cmd_names),
        meta_json=np.array(json.dumps(trace.meta)),
        group=trace.group,
        **{f: getattr(trace, f) for f in FIELDS})
    return path


def load(path: str) -> CommandTrace:
    """Load a trace artifact of any version up to the current one."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["__version__"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"trace artifact version {version} is newer "
                             f"than supported {_FORMAT_VERSION}")
        cols = {f: np.ascontiguousarray(z[f], np.int32)
                for f in FIELDS if f in z}
        cols.setdefault("chan", None)                # v1: no chan column
        if "group" in z:
            cols["group"] = np.ascontiguousarray(z["group"], np.int32)
        return CommandTrace(
            n_cycles=int(z["n_cycles"]),
            cmd_names=[str(n) for n in z["cmd_names"]],
            meta=json.loads(str(z["meta_json"])),
            **cols)


def iter_records(trace: CommandTrace, start: int = 0,
                 stop: int | None = None):
    """Yield ``{clk, cmd, bank, row, bus, arrive, chan, group}`` dicts
    (command names resolved) for the commands with ``start <= clk <
    stop``, in issue order."""
    names = trace.cmd_names
    clk = trace.clk
    lo = int(np.searchsorted(clk, start, side="left"))
    hi = len(clk) if stop is None else \
        int(np.searchsorted(clk, stop, side="left"))
    for i in range(lo, hi):
        yield {"clk": int(clk[i]), "cmd": names[int(trace.cmd[i])],
               "bank": int(trace.bank[i]), "row": int(trace.row[i]),
               "bus": int(trace.bus[i]), "arrive": int(trace.arrive[i]),
               "chan": int(trace.chan[i]), "group": int(trace.group[i])}


def write_jsonl(trace: CommandTrace, path_or_file) -> int:
    """Stream the trace as JSON Lines: a header line with the metadata,
    then one line per command.  Returns the number of command lines."""
    own = isinstance(path_or_file, str)
    f = open(path_or_file, "w") if own else path_or_file
    try:
        header = {"type": "trace_header", "n_cycles": trace.n_cycles,
                  "n_commands": len(trace), "meta": trace.meta}
        f.write(json.dumps(header) + "\n")
        n = 0
        for rec in iter_records(trace):
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            n += 1
        return n
    finally:
        if own:
            f.close()


def read_jsonl(path_or_file) -> CommandTrace:
    """Rebuild a :class:`CommandTrace` from :func:`write_jsonl` output
    (``hit_ready`` is not exported and reads back as zeros)."""
    own = isinstance(path_or_file, str)
    f = open(path_or_file) if own else path_or_file
    try:
        header = json.loads(f.readline())
        if header.get("type") != "trace_header":
            raise ValueError("missing trace_header line")
        meta = header["meta"]
        recs = [json.loads(line) for line in f if line.strip()]
    finally:
        if own:
            f.close()
    # command names come from the spec or system the metadata rebuilds
    if "system" in meta:
        names = list(system_from_meta(meta).cmd_names)
    else:
        from repro_torch.core.compile import compile_spec
        names = list(compile_spec(
            meta["standard"], meta["org_preset"], meta["timing_preset"],
            {k: int(v) for k, v in meta["timings"].items()},
            channels=int(meta.get("n_channels", 1))).cmd_names)
    i32 = lambda k, d=0: np.asarray([r.get(k, d) for r in recs], np.int32)
    return CommandTrace(
        clk=i32("clk"), cmd=np.asarray([names.index(r["cmd"]) for r in recs],
                                       np.int32),
        bank=i32("bank"), row=i32("row"), bus=i32("bus"),
        arrive=i32("arrive", -1), hit_ready=np.zeros(len(recs), np.int32),
        chan=i32("chan"), group=i32("group"),
        n_cycles=int(header["n_cycles"]), cmd_names=names, meta=meta)
