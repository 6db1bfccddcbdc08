"""PyTorch port, the audit and both visualizers against the reference's on
the same inputs, exactly, on the CPU.

* Random command traces (numpy seeds, violations included) on one DDR4
  channel, two HBM3 channels and the DDR5 + CXL-DDR4 system (a ``group``
  column, each group audited against its own table): both packages'
  ``audit`` give the same report, and ``trace.viz.render_html`` the same
  page byte for byte (raw records and LOD bins alone).
* Windowed telemetry of port runs (one DDR4 channel; the hetero system),
  handed to the reference through the shared ``.npz`` format:
  ``telemetry.viz.render_html`` gives the reference's page byte for byte.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import telemetry as JTel                        # noqa: E402
from repro import trace as JT                              # noqa: E402
from repro.core import compile_spec as jcompile            # noqa: E402
from repro.core import compile_system as jsystem           # noqa: E402
from repro_torch import telemetry as TTel                  # noqa: E402
from repro_torch import trace as TT                        # noqa: E402
from repro_torch.core import Simulator                     # noqa: E402
from repro_torch.core import compile_spec as tcompile      # noqa: E402
from repro_torch.core import compile_system as tsystem     # noqa: E402

import torch_parity as tp                                  # noqa: E402

HETERO = [dict(standard="DDR5", org_preset="DDR5_16Gb_x8",
               timing_preset="DDR5_4800B", channels=1),
          dict(standard="DDR4", org_preset="DDR4_8Gb_x8",
               timing_preset="DDR4_2400R", channels=2, link_latency=40)]


def _columns(seed, n, n_cycles, n_names, n_banks, channels, groups=None):
    """Random trace columns in issue order (sorted clocks)."""
    rng = np.random.default_rng(seed)
    clk = np.sort(rng.integers(0, n_cycles, n))
    chan = rng.integers(0, channels, n)
    cols = dict(clk=clk, cmd=rng.integers(0, n_names, n),
                bank=rng.integers(0, n_banks, n), row=rng.integers(0, 8, n),
                bus=rng.integers(0, 2, n),
                arrive=np.where(rng.random(n) < 0.6, clk - 3, -1),
                hit_ready=rng.integers(0, 2, n), chan=chan)
    if groups is not None:
        cols["group"] = groups[chan]
    return {k: np.ascontiguousarray(v, np.int32) for k, v in cols.items()}


def _pair(kind, seed):
    """``(reference spec, its trace, port spec, its trace)`` of one random
    trace with the capture metadata of its spec."""
    if kind == "hetero":
        jspec, tspec = jsystem(HETERO), tsystem(HETERO)
        cols = _columns(seed, 400, 2000, len(tspec.cmd_names), 16, 3,
                        np.asarray(tspec.chan_group))
        # each command id must be one of its group's merged ids
        for g in range(tspec.n_groups):
            ids = np.asarray(tspec.group_cmd_maps[g])
            m = cols["group"] == g
            cols["cmd"][m] = ids[cols["cmd"][m] % len(ids)]
        names = list(tspec.cmd_names)
    else:
        args = (("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", 1) if kind == "ddr4"
                else ("HBM3", "HBM3_16Gb", "HBM3_5200", 2))
        jspec, tspec = jcompile(*args[:3], channels=args[3]), \
            tcompile(*args[:3], channels=args[3])
        cols = _columns(seed, 500, 3000, tspec.n_cmds,
                        min(tspec.n_banks, 16), args[3])
        names = list(tspec.cmd_names)
    meta = TT.base_meta(tspec)
    meta["controller"] = {"scheduler": "FRFCFS"}
    jtr = JT.CommandTrace(n_cycles=3000, cmd_names=names, meta=dict(meta),
                          **cols)
    ttr = TT.CommandTrace(n_cycles=3000, cmd_names=names, meta=dict(meta),
                          **cols)
    return jspec, jtr, tspec, ttr


@pytest.mark.parametrize("kind", ["ddr4", "hbm3x2", "hetero"])
@pytest.mark.parametrize("seed", [0, 1])
def test_audit_and_trace_page_equal_the_references(kind, seed):
    jspec, jtr, tspec, ttr = _pair(kind, seed)
    assert TT.spec_fingerprint_hex(tspec) == JT.spec_fingerprint_hex(jspec)
    jrep, trep = JT.audit(jspec, jtr), TT.audit(tspec, ttr)
    assert tp.audit_doc(trep) == tp.audit_doc(jrep)
    assert not trep.ok                     # random streams violate timing
    for kw in (dict(title="t"), dict(raw_limit=0, n_bins=64)):
        assert TT.render_html(ttr, tspec, trep, **kw) == \
            JT.render_html(jtr, jspec, jrep, **kw)
    assert TT.render_html(ttr, tspec) == JT.render_html(jtr, jspec)


@pytest.mark.parametrize("which", ["ddr4", "hetero"])
def test_telemetry_page_equals_the_references(which, tmp_path):
    if which == "ddr4":
        sim = Simulator("DDR4", "DDR4_8Gb_x8", "DDR4_2400R", device="cpu")
        n, w = 1200, 128
    else:
        sim = Simulator(system=HETERO, device="cpu")
        n, w = 600, 64
    _, telem = sim.run(n, interval=2.0, read_ratio=0.7, telemetry=w)
    p = TTel.save(telem, str(tmp_path / "w.npz"))
    page = TTel.render_html(telem)
    assert page == JTel.render_html(JTel.load(p))
    out = TTel.write_html(str(tmp_path / "w.html"), telem)
    assert open(out).read() == page
