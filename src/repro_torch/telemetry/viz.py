"""Telemetry timeline: standalone HTML rendering of one run's windowed
metrics, in the same level-of-detail (LOD) style as the trace visualizer
(:mod:`repro_torch.trace.viz`, whose palette it shares).  The port's
copy of ``repro.telemetry.viz``: its HTML is byte for byte the
reference's for the same telemetry.

Python precomputes mean-pooled LOD levels (x4 decimation per level) of
every per-window series; the JS canvas renderer picks the coarsest level
that still gives >= ~2 windows per pixel at the current zoom, so payload
size and draw cost stay bounded for million-window runs.  Lanes, top to
bottom: per-channel bandwidth (GB/s, each channel a palette color,
heterogeneous channels labeled by standard), mean queue occupancy,
row-hit rate, refresh + deferred activity, and a served-probe latency
heatmap (bucket edges from ``CompiledSpec.lat_bucket_edges``).  Wheel =
zoom, drag = pan, double-click = reset.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.trace.viz import PALETTE

from repro_torch.telemetry.core import Telemetry

#: windows per LOD bin at successive levels (level 0 is raw)
LOD_FACTOR = 4
#: stop adding levels once a level fits in this many bins
LOD_MIN_BINS = 512


def _pool(a: np.ndarray, f: int, how: str) -> np.ndarray:
    """Pool axis 0 of ``a`` by factor ``f`` (ragged tail kept)."""
    n = a.shape[0]
    nb = (n + f - 1) // f
    pad = nb * f - n
    if pad:
        padv = np.concatenate([a, np.full((pad,) + a.shape[1:], np.nan
                               if how == "mean" else 0, float)])
    else:
        padv = a.astype(float)
    r = padv.reshape((nb, f) + a.shape[1:])
    if how == "mean":
        with np.errstate(invalid="ignore"):
            return np.nanmean(r, axis=1)
    return np.nansum(r, axis=1)


def _levels(a: np.ndarray, how: str) -> list:
    """LOD pyramid of ``a``: [raw, x4, x16, ...] as nested lists (NaN ->
    None via json round-trip handled by _clean)."""
    out, cur = [a.astype(float)], a.astype(float)
    while cur.shape[0] > LOD_MIN_BINS:
        cur = _pool(cur, LOD_FACTOR, how)
        out.append(cur)
    return out


def _clean(x):
    """NaN -> None recursively for JSON."""
    if isinstance(x, np.ndarray):
        return _clean(x.tolist())
    if isinstance(x, list):
        return [_clean(v) for v in x]
    if isinstance(x, float) and x != x:
        return None
    return x


def _payload(telem: Telemetry) -> dict:
    widths = telem.widths
    chans, bw, occ, hit = [], [], [], []
    refresh, deferred, hist = [], [], []
    edges = ()
    for g, gt in enumerate(telem.groups):
        b = gt.bandwidth_gbps(widths)
        o = gt.occupancy(widths)
        h = gt.row_hit_rate()
        for c in range(gt.channels):
            label = f"ch{len(chans)}"
            if len(telem.groups) > 1:
                label += f" {gt.standard}"
            chans.append(label)
            bw.append(b[:, c])
            occ.append(o[:, c])
            hit.append(h[:, c])
        refresh.append(gt.refreshes().sum(axis=1))
        deferred.append(gt.deferred.sum(axis=1))
        hist.append(gt.lat_hist.sum(axis=1))       # (W, n_buckets)
        if g == 0:
            edges = gt.lat_edges
    stack = lambda xs: np.stack(xs, axis=1)         # (W, lanes)
    return {
        "window": telem.window, "n_cycles": telem.n_cycles,
        "t_end": telem.t_end.tolist(), "channels": chans,
        "label": telem.meta.get("label", ""),
        "palette": PALETTE,
        "lat_edges": list(edges),
        "bw": _clean(_levels(stack(bw), "mean")),
        "occ": _clean(_levels(stack(occ), "mean")),
        "hit": _clean(_levels(stack(hit), "mean")),
        "refresh": _clean(_levels(stack(refresh).sum(axis=1), "sum")),
        "deferred": _clean(_levels(stack(deferred).sum(axis=1), "sum")),
        "hist": _clean(_levels(sum(hist[1:], hist[0]), "sum")),
    }


_HTML = """<!doctype html>
<meta charset="utf-8">
<title>telemetry — {label}</title>
<style>
 body {{ background:#16191e; color:#cfd6e4; margin:0;
        font:13px/1.4 system-ui, sans-serif; }}
 h1 {{ font-size:15px; margin:10px 14px 2px; }}
 #sub {{ margin:0 14px 8px; color:#8a94a6; }}
 .lane {{ margin:4px 14px; }}
 .lane .t {{ color:#8a94a6; font-size:11px; margin-bottom:2px; }}
 canvas {{ display:block; width:100%; background:#1d2127;
          border:1px solid #2a2f38; border-radius:4px; }}
 #legend span {{ margin-right:12px; }}
 #legend i {{ display:inline-block; width:10px; height:10px;
             border-radius:2px; margin-right:4px; }}
</style>
<h1>windowed telemetry — {label}</h1>
<p id="sub"></p>
<div class="lane" id="legend"></div>
<div class="lane"><div class="t">bandwidth (GB/s, per channel)</div>
 <canvas id="bw" height="140"></canvas></div>
<div class="lane"><div class="t">mean queue occupancy (slots)</div>
 <canvas id="occ" height="90"></canvas></div>
<div class="lane"><div class="t">row-hit rate</div>
 <canvas id="hit" height="90"></canvas></div>
<div class="lane"><div class="t">refresh (bars) + deferred (line), per
 window</div><canvas id="ref" height="70"></canvas></div>
<div class="lane"><div class="t">served-probe latency histogram
 (bucket x window, log color)</div>
 <canvas id="lat" height="110"></canvas></div>
<script>
const D = {payload};
const W0 = D.t_end.length, CYC = D.n_cycles, LODF = {lodf};
let x0 = 0, x1 = CYC;                       // visible cycle span
const sub = document.getElementById('sub');
sub.textContent = W0 + ' windows of ' + D.window + ' cycles over ' +
  CYC.toLocaleString() + ' cycles';
const leg = document.getElementById('legend');
D.channels.forEach((c, i) => {{
  const s = document.createElement('span');
  s.innerHTML = '<i style="background:' +
    D.palette[i % D.palette.length] + '"></i>' + c;
  leg.appendChild(s);
}});
function lvlFor(cv) {{                      // coarsest level, >=2 win/px
  const winSpan = (x1 - x0) / D.window;
  let lvl = 0, per = 1;
  while (lvl + 1 < D.bw.length && winSpan / (per * LODF) > cv.width / 2)
    {{ lvl++; per *= LODF; }}
  return [lvl, per];
}}
function setup(cv) {{
  const r = cv.getBoundingClientRect();
  cv.width = r.width * devicePixelRatio;
  cv.height = cv.getAttribute('height') * devicePixelRatio;
  const g = cv.getContext('2d');
  g.scale(devicePixelRatio, devicePixelRatio);
  return [g, r.width, +cv.getAttribute('height')];
}}
function series(cv, data, opts) {{
  const [g, w, h] = setup(cv), [lvl, per] = lvlFor(cv);
  const rows = data[lvl], lanes = Array.isArray(rows[0]) ? rows[0].length : 1;
  let max = opts.max || 0;
  if (!max) {{ rows.forEach(r => (Array.isArray(r) ? r : [r]).forEach(
      v => {{ if (v != null && v > max) max = v; }})); max = max || 1; }}
  g.clearRect(0, 0, w, h);
  for (let ln = 0; ln < lanes; ln++) {{
    g.strokeStyle = opts.color || D.palette[ln % D.palette.length];
    g.lineWidth = 1.2; g.beginPath(); let pen = false;
    for (let i = 0; i < rows.length; i++) {{
      const cyc = (i + 0.5) * per * D.window;
      if (cyc < x0 - per * D.window || cyc > x1 + per * D.window) continue;
      const v = Array.isArray(rows[i]) ? rows[i][ln] : rows[i];
      if (v == null) {{ pen = false; continue; }}
      const x = (cyc - x0) / (x1 - x0) * w;
      const y = h - 4 - (v / max) * (h - 12);
      pen ? g.lineTo(x, y) : g.moveTo(x, y); pen = true;
    }}
    g.stroke();
  }}
  g.fillStyle = '#8a94a6'; g.font = '10px system-ui';
  g.fillText(opts.fmt ? opts.fmt(max) : max.toFixed(2), 4, 11);
}}
function heat(cv) {{
  const [g, w, h] = setup(cv), [lvl, per] = lvlFor(cv);
  const rows = D.hist[lvl], nb = rows[0].length;
  let max = 1; rows.forEach(r => r.forEach(v => {{ if (v > max) max = v; }}));
  g.clearRect(0, 0, w, h);
  const bh = h / nb;
  for (let i = 0; i < rows.length; i++) {{
    const c0 = i * per * D.window, c1 = (i + 1) * per * D.window;
    if (c1 < x0 || c0 > x1) continue;
    const x = (c0 - x0) / (x1 - x0) * w;
    const bw_ = Math.max((c1 - c0) / (x1 - x0) * w, 1);
    for (let b = 0; b < nb; b++) {{
      const v = rows[i][b]; if (!v) continue;
      const a = Math.log1p(v) / Math.log1p(max);
      g.fillStyle = 'rgba(242,142,43,' + (0.08 + 0.92 * a).toFixed(3) + ')';
      g.fillRect(x, h - (b + 1) * bh, bw_, bh - 0.5);
    }}
  }}
  g.fillStyle = '#8a94a6'; g.font = '10px system-ui';
  g.fillText('<=' + (D.lat_edges[0] || '?') + 'cy', 4, h - 2);
  g.fillText('>' + (D.lat_edges[D.lat_edges.length - 1] || '?') + 'cy',
             4, 11);
}}
function draw() {{
  series(document.getElementById('bw'), D.bw, {{}});
  series(document.getElementById('occ'), D.occ, {{}});
  series(document.getElementById('hit'), D.hit,
         {{max: 1, fmt: v => '100%'}});
  series(document.getElementById('ref'), D.refresh,
         {{color: '#76b7b2', fmt: v => v.toFixed(0)}});
  series(document.getElementById('ref'), D.deferred,
         {{color: '#e15759', fmt: v => ''}});
  heat(document.getElementById('lat'));
}}
let dragX = null;
document.querySelectorAll('canvas').forEach(cv => {{
  cv.addEventListener('wheel', e => {{
    e.preventDefault();
    const r = cv.getBoundingClientRect();
    const fx = (e.clientX - r.left) / r.width;
    const c = x0 + fx * (x1 - x0);
    const z = e.deltaY > 0 ? 1.25 : 0.8;
    x0 = Math.max(0, c - (c - x0) * z);
    x1 = Math.min(CYC, c + (x1 - c) * z);
    draw();
  }}, {{passive: false}});
  cv.addEventListener('mousedown', e => dragX = e.clientX);
  cv.addEventListener('mousemove', e => {{
    if (dragX == null) return;
    const r = cv.getBoundingClientRect();
    const d = (e.clientX - dragX) / r.width * (x1 - x0);
    if (x0 - d >= 0 && x1 - d <= CYC) {{ x0 -= d; x1 -= d; draw(); }}
    dragX = e.clientX;
  }});
  cv.addEventListener('dblclick', () => {{ x0 = 0; x1 = CYC; draw(); }});
}});
window.addEventListener('mouseup', () => dragX = null);
window.addEventListener('resize', draw);
draw();
</script>
"""


def render_html(telem: Telemetry) -> str:
    """Render the standalone timeline HTML for one telemetry series."""
    return _HTML.format(label=telem.meta.get("label", "run"),
                        payload=json.dumps(_payload(telem)),
                        lodf=LOD_FACTOR)


def write_html(path: str, telem: Telemetry) -> str:
    with open(path, "w") as f:
        f.write(render_html(telem))
    return path
