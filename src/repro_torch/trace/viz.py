"""Command-trace visualizer (paper §4.1, Fig. 2) on top of ``CommandTrace``.

The port's copy of ``repro.trace.viz``: host code whose HTML is byte for
byte the reference's for the same trace (the page title included).

Standalone HTML, two linked views as in the paper — (a) bus utilization,
(b) per-bank command trace — plus an audit-violation overlay lane fed by
:mod:`repro_torch.trace.audit`.

Scale: the renderer is level-of-detail (LOD) binned.  Python precomputes a
fixed number of time bins (per-bin C/A and data-bus occupancy, and per
(bin, lane) dominant-command densities); raw per-command records are only
embedded when the trace is small enough (``raw_limit``).  Zoomed out — or
for multi-million-command traces with no raw records at all — the command
view draws the binned densities; zoomed in with raw records available it
draws exact per-command rectangles.  Payload size and draw cost are
therefore bounded by the bin count, not the trace length.

Bus-utilization denominators are *derived*, not hardcoded: a bin of
``bw`` cycles offers ``bw x n_command_buses x n_channels`` C/A slots (two
buses for dual-C/A standards such as HBM3/GDDR7, times the memory-system
channel count) and ``bw x n_channels`` data-bus cycles, of which each
final RD/WR occupies ``nBL``.

Multi-channel traces render as stacked per-channel lane groups (each
channel: its banks + a refresh-engine lane), labeled ``chN bM`` /
``chN ref``; the audit-violation overlay lane is shared at the bottom.
"""
from __future__ import annotations

import json
import math

import numpy as np

from repro_torch.core import spec as S
from repro_torch.core.compile import as_system
from repro_torch.trace.capture import CommandTrace

PALETTE = ["#4e79a7", "#f28e2b", "#e15759", "#76b7b2", "#59a14f",
           "#edc948", "#b07aa1", "#ff9da7", "#9c755f", "#bab0ac",
           "#86bcb6", "#d37295"]

#: Cap on violations embedded in the overlay payload.
MAX_OVERLAY_VIOLATIONS = 500


class _View:
    """Per-system-channel display geometry: lane bases, bank counts, data
    burst lengths, and lane labels — possibly different per channel for a
    heterogeneous system (lanes are labeled by standard)."""

    def __init__(self, msys, trace: CommandTrace):
        self.msys = msys
        nch = msys.n_channels
        self.n_banks = np.asarray(
            [msys.groups[g].cspec.n_banks for g in msys.chan_group],
            np.int64)
        self.nbl = np.asarray(
            [int(msys.groups[g].cspec.timings["nBL"])
             for g in msys.chan_group], np.int64)
        self.lane_base = np.concatenate(
            [[0], np.cumsum(self.n_banks + 1)[:-1]])
        self.n_lanes = int(np.sum(self.n_banks + 1))
        self.n_cmd_buses = sum(
            (2 if msys.groups[g].cspec.dual_command_bus else 1)
            for g in msys.chan_group)
        # merged-namespace command kinds (groups agree on shared names'
        # kinds in practice; first writer wins) for the legacy fallback
        kind = np.zeros(len(trace.cmd_names), np.int64)
        for g in range(msys.n_groups - 1, -1, -1):
            kind[msys.group_cmd_maps[g]] = msys.groups[g].cspec.cmd_kind
        self.kind = kind
        hetero = msys.n_groups > 1
        self.lane_names = []
        for c in range(nch):
            std = msys.groups[msys.chan_group[c]].cspec.standard
            for b in range(int(self.n_banks[c])):
                if nch == 1:
                    self.lane_names.append(f"bank {b}")
                elif hetero:
                    self.lane_names.append(f"ch{c} {std} b{b}")
                else:
                    self.lane_names.append(f"ch{c} b{b}")
            if nch == 1:
                self.lane_names.append("refresh")
            elif hetero:
                self.lane_names.append(f"ch{c} {std} ref")
            else:
                self.lane_names.append(f"ch{c} ref")

    def lanes(self, trace: CommandTrace) -> np.ndarray:
        """Display lane per command: channel-major — each channel
        contributes its banks plus one refresh-engine lane.  Traces
        without request info (legacy 3-array captures have ``arrive == -1``
        everywhere) fall back to command kind, and negative banks are
        always routed to their channel's refresh lane."""
        if bool(np.any(trace.arrive >= 0)):
            refresh = trace.arrive < 0
        else:
            refresh = self.kind[trace.cmd] == S.KIND_REF
        nb = self.n_banks[trace.chan]
        local = np.where(refresh | (trace.bank < 0), nb,
                         np.minimum(trace.bank, nb))
        return self.lane_base[trace.chan] + local


def _bin_payload(trace: CommandTrace, view: _View, n_bins: int) -> dict:
    """Precompute the LOD summaries: per-bin bus occupancy and per
    (bin, lane) dominant command + count.  Data-bus occupancy weighs each
    final RD/WR by its OWN channel's burst length (heterogeneous groups
    have different nBL)."""
    T = max(1, trace.n_cycles)
    bw = max(1, math.ceil(T / n_bins))
    nb = math.ceil(T / bw)
    n_lanes = view.n_lanes
    b = trace.clk // bw

    ca = np.bincount(b, minlength=nb)
    msys = view.msys
    n_names = len(trace.cmd_names)
    fx_lut = np.zeros((msys.n_groups, n_names), np.int64)
    for g, grp in enumerate(msys.groups):
        fx_lut[g, msys.group_cmd_maps[g]] = grp.cspec.cmd_fx
    fx = fx_lut[trace.group, trace.cmd]
    final = (fx & (S.FX_FINAL_RD | S.FX_FINAL_WR)) != 0
    data = np.bincount(b[final], weights=view.nbl[trace.chan[final]],
                       minlength=nb).astype(np.int64)

    lane = view.lanes(trace)
    flat = b.astype(np.int64) * n_lanes + lane
    counts = np.zeros((n_names, nb * n_lanes), np.int32)
    for c in range(n_names):
        m = trace.cmd == c
        if m.any():
            counts[c] = np.bincount(flat[m], minlength=nb * n_lanes)
    dom = counts.argmax(axis=0).astype(np.int32)
    cnt = counts.sum(axis=0).astype(np.int32)
    dom[cnt == 0] = -1
    return {"bw": bw, "nb": nb, "n_lanes": n_lanes,
            "ca": ca.tolist(), "data": data.tolist(),
            "dom": dom.tolist(), "cnt": cnt.tolist()}


def render_html(trace: CommandTrace, cspec=None, report=None,
                title: str = "", n_bins: int = 2048,
                raw_limit: int = 100_000) -> str:
    """Render the two-view HTML.  ``cspec`` may be a CompiledSpec, a
    :class:`repro_torch.core.compile.MemorySystemSpec` (heterogeneous traces
    label their lanes by standard), or None (recompiled from the trace).
    ``report`` (an :class:`repro_torch.trace.audit.AuditReport`) adds the
    violation overlay."""
    if cspec is None:
        msys = trace.compiled_system()
    else:
        msys = as_system(cspec)
    view = _View(msys, trace)
    colors = {name: PALETTE[i % len(PALETTE)]
              for i, name in enumerate(trace.cmd_names)}

    recs = None
    if len(trace) <= raw_limit:
        lane = view.lanes(trace)
        recs = {"clk": trace.clk.tolist(), "cmd": trace.cmd.tolist(),
                "lane": lane.tolist(), "row": trace.row.tolist(),
                "bus": trace.bus.tolist()}

    viols = []
    if report is not None:
        for v in report.violations[:MAX_OVERLAY_VIOLATIONS]:
            viols.append({"clk": v.clk, "cmd": v.cmd,
                          "label": f"{v.check}: {v.constraint}"})
    payload = {
        "title": title or f"{msys.label} command trace",
        "standard": msys.label,
        "n_channels": int(msys.n_channels),
        "n_cycles": int(trace.n_cycles),
        "n_commands": len(trace),
        "n_cmd_buses": view.n_cmd_buses,    # summed across channels
        "cmd_names": list(trace.cmd_names),
        "colors": colors,
        "lane_names": view.lane_names,
        "bins": _bin_payload(trace, view, n_bins),
        "recs": recs,
        "viols": viols,
        "n_violations": 0 if report is None else report.n_violations,
        "audited": report is not None,
    }
    return _TEMPLATE.replace("__PAYLOAD__", json.dumps(payload))


def write_html(path: str, trace: CommandTrace, cspec=None, report=None,
               title: str = "", n_bins: int = 2048,
               raw_limit: int = 100_000) -> str:
    html = render_html(trace, cspec, report, title, n_bins, raw_limit)
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Ramulator-JAX trace</title>
<style>
 body{font-family:system-ui,sans-serif;margin:12px;background:#fafafa}
 h2{margin:4px 0} .views{display:flex;flex-direction:column;gap:12px}
 canvas{background:#fff;border:1px solid #ccc;width:100%}
 #tip{position:fixed;background:#222;color:#fff;padding:4px 8px;
      border-radius:4px;font-size:12px;pointer-events:none;display:none;
      max-width:480px}
 .legend span{display:inline-block;margin-right:10px;font-size:12px}
 .legend i{display:inline-block;width:10px;height:10px;margin-right:3px}
 .bar{display:flex;gap:16px;align-items:center;font-size:13px}
 .viol{color:#c0392b;font-weight:600}
</style></head><body>
<h2 id="title"></h2>
<div class="bar">
  <label>zoom <input id="zoom" type="range" min="0" max="100" value="35"></label>
  <label>offset <input id="off" type="range" min="0" max="1000" value="0"></label>
  <span id="stats"></span>
</div>
<div class="views">
 <div><b>(a) bus utilization</b><canvas id="bus" height="140"></canvas></div>
 <div><b>(b) command trace</b><canvas id="cmds" height="460"></canvas></div>
</div>
<div class="legend" id="legend"></div>
<div id="tip"></div>
<script>
const D = __PAYLOAD__;
const ML = 60;                       // left margin for lane labels
document.getElementById('title').textContent = D.title;
const maxClk = Math.max(1, D.n_cycles);
const legend = document.getElementById('legend');
for (const [name,col] of Object.entries(D.colors)) {
  const s=document.createElement('span');
  s.innerHTML='<i style="background:'+col+'"></i>'+name; legend.appendChild(s);
}
const busC = document.getElementById('bus'), cmdC = document.getElementById('cmds');
const tip = document.getElementById('tip');
// zoom slider is log-scale: 0 -> whole trace fits, 100 -> 10 px per clk
let pxPerClk = 1, off = 0;
function zoomVal(v){
  const fit = (cmdC.width - ML - 10) / maxClk;
  return fit * Math.pow(10/fit, v/100);
}
document.getElementById('zoom').oninput = e=>{
  pxPerClk = zoomVal(+e.target.value); draw();};
document.getElementById('off').oninput = e=>{
  off = +e.target.value/1000*maxClk; draw();};
function layout(){
  busC.width = busC.clientWidth; cmdC.width = cmdC.clientWidth;
  pxPerClk = zoomVal(+document.getElementById('zoom').value); draw();
}
const N_LANES = D.lane_names.length; // channel lane groups (possibly
                                     // heterogeneous bank counts)
function laneGeom(){
  // per-channel lane groups + one shared audit-violation lane
  const lanes = N_LANES + 1;
  const laneH = Math.max(5, Math.floor((cmdC.height-24)/lanes));
  return {lanes, laneH};
}
function laneName(l){
  return (l >= N_LANES) ? 'audit' : D.lane_names[l];
}
function drawCmds(){
  const W = cmdC.width, {lanes, laneH} = laneGeom();
  const g = cmdC.getContext('2d'); g.clearRect(0,0,W,cmdC.height);
  g.font='10px sans-serif'; g.fillStyle='#888';
  for (let l=0;l<N_LANES;l++)
    g.fillText(laneName(l), 2, 8+l*laneH+laneH*0.7);
  g.fillStyle='#c0392b';
  g.fillText('audit', 2, 8+N_LANES*laneH+laneH*0.7);
  const x0 = clk => (clk-off)*pxPerClk + ML;
  const rawMode = D.recs && pxPerClk >= 0.5;
  if (rawMode){
    const recs = D.recs, n = recs.clk.length;
    // visible clk range -> index range (clk array is sorted)
    const lo = off - 2/pxPerClk, hi = off + (W-ML)/pxPerClk + 2;
    let i0 = lowerBound(recs.clk, lo), i1 = lowerBound(recs.clk, hi);
    for (let i=i0;i<i1;i++){
      const x = x0(recs.clk[i]);
      g.fillStyle = D.colors[D.cmd_names[recs.cmd[i]]]||'#000';
      g.fillRect(x, 8+recs.lane[i]*laneH,
                 Math.max(2,pxPerClk*0.9), laneH-2);
    }
  } else {
    const B = D.bins, bw = B.bw;
    for (let i=0;i<B.nb;i++){
      const x = x0(i*bw), w = Math.max(1, bw*pxPerClk);
      if (x+w < ML-10 || x > W) continue;
      for (let l=0;l<B.n_lanes;l++){
        const c = B.cnt[i*B.n_lanes+l];
        if (!c) continue;
        const name = D.cmd_names[B.dom[i*B.n_lanes+l]];
        g.fillStyle = D.colors[name]||'#000';
        g.globalAlpha = Math.min(1, 0.25 + c/bw);
        g.fillRect(x, 8+l*laneH, w, laneH-2);
      }
    }
    g.globalAlpha = 1;
  }
  // audit-violation overlay lane
  const vy = 8+(D.n_channels*CH_LANES)*laneH;
  for (const v of D.viols){
    const x = x0(v.clk);
    if (x < ML-10 || x > W) continue;
    g.fillStyle='#c0392b';
    g.fillRect(x, vy, Math.max(2,pxPerClk*0.9), laneH-2);
  }
  const mode = rawMode ? 'exact' : ('binned x'+D.bins.bw);
  const v = D.audited
    ? (D.n_violations ? ' — '+D.n_violations+' audit violations' : ' — audit clean')
    : '';
  const st = document.getElementById('stats');
  st.innerHTML = D.n_commands+' commands, '+maxClk+' cycles ['+mode+']'
    + (D.n_violations ? '<span class="viol">'+v+'</span>' : v);
}
function drawBus(){
  const bg = busC.getContext('2d');
  bg.clearRect(0,0,busC.width,busC.height);
  const B = D.bins, bw = B.bw;
  // derived denominators: each channel contributes its own C/A + data bus
  // D.n_cmd_buses is already summed across channels
  const caCap = bw * D.n_cmd_buses;       // C/A slots per bin
  const dataCap = bw * D.n_channels;      // data-bus cycles per bin
  const w = Math.max(1, (busC.width-ML-10)/B.nb);
  bg.fillStyle='#888'; bg.font='10px sans-serif';
  bg.fillText('C/A bus', 2, 30); bg.fillText('data bus', 2, 100);
  for (let i=0;i<B.nb;i++){
    const u = Math.min(1, B.ca[i]/caCap);
    const d = Math.min(1, B.data[i]/dataCap);
    bg.fillStyle='#4e79a7';
    bg.fillRect(ML+i*w, 50-40*u, Math.max(1,w-0.5), 40*u);
    bg.fillStyle='#e15759';
    bg.fillRect(ML+i*w, 120-40*d, Math.max(1,w-0.5), 40*d);
  }
}
function draw(){ drawCmds(); drawBus(); }
function lowerBound(a, x){
  let lo=0, hi=a.length;
  while (lo<hi){ const m=(lo+hi)>>1; if (a[m]<x) lo=m+1; else hi=m; }
  return lo;
}
cmdC.onmousemove = e=>{
  const rect = cmdC.getBoundingClientRect();
  const clk = Math.round((e.clientX-rect.left-ML)/pxPerClk + off);
  const lines = [];
  const vnear = D.viols.filter(v=>Math.abs(v.clk-clk)<=Math.max(1,1/pxPerClk));
  for (const v of vnear) lines.push('VIOLATION '+v.label+' @ clk '+v.clk);
  if (D.recs){
    const recs = D.recs;
    const i0 = lowerBound(recs.clk, clk-1), i1 = lowerBound(recs.clk, clk+2);
    for (let i=i0;i<i1 && lines.length<8;i++)
      lines.push(D.cmd_names[recs.cmd[i]]+'@clk'+recs.clk[i]
                 +' '+laneName(recs.lane[i])
                 +(recs.row[i]>=0?' row'+recs.row[i]:''));
  } else {
    const B = D.bins, b = Math.floor(clk/B.bw);
    if (b>=0 && b<B.nb)
      lines.push('bin '+b+': '+B.ca[b]+' cmds, data '+B.data[b]+'/'+B.bw);
  }
  if (lines.length && clk>=0 && clk<=maxClk){
    tip.style.display='block'; tip.style.left=(e.clientX+12)+'px';
    tip.style.top=(e.clientY+12)+'px';
    tip.textContent = lines.join(' | ');
  } else tip.style.display='none';
};
cmdC.onmouseleave = ()=>{tip.style.display='none';};
window.onresize = layout; layout();
</script></body></html>
"""
