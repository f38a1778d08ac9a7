"""Interactive HTML result explorer (counterpart of the JAX package's
viz_html.py) — the answer to the one GUI
capability the static PNGs of :mod:`viz` do not cover: *interactive*
exploration of a solve (reference Qt GUI: rotatable/zoomable Q3DSurface with
per-series visibility toggles, qt_gui/src/mainwindow.cpp:796-917; live chart
series switching, :447-634; hoverable error heatmap dialog, :1139-1298).

:func:`export_html` writes ONE standalone file — embedded JSON payload +
vanilla-JS canvas renderers, no external assets, so it opens from disk on any
machine (`file://`), which is the cluster-friendly redesign of a desktop
GUI: solve remotely, scp one file, explore locally.

Views (tabs):

- **Surface** — the Г-shaped 3D surface, drag to rotate / wheel to zoom,
  field toggles (numeric / true / error), height-colored by a sequential ramp.
- **Heatmap** — per-cell hover readout (x, y, value) + min/max/avg stats of
  the FULL field (stats are computed here in Python before any down-sampling).
- **Scatter** — per-node quantity vs x (the reference's 2D chart combo box).
- **Convergence** — log10 norms vs iteration, series legend toggles,
  crosshair + shared tooltip.
- **Data** — run metadata and the convergence history as tables (the
  accessibility table-view for every chart).

Large grids are down-sampled to ``max_cells`` nodes per axis for embedding
(an 8192² field is 537 MB of JSON; 129² of samples is what a screen can show
anyway); the heatmap stats always reflect the full field.
"""

from __future__ import annotations

import html as _html
import json
from typing import Optional

import numpy as np

__all__ = ["export_html"]

_FIELD_KEYS = ("solution", "true_solution", "error", "residual")


def _sample_idx(n: int, max_cells: int) -> np.ndarray:
    """≤ max_cells strictly increasing indices covering [0, n-1] incl. ends."""
    if n <= max_cells:
        return np.arange(n)
    return np.unique(np.round(np.linspace(0, n - 1, max_cells)).astype(int))


def _field_rows(field: np.ndarray, iy: np.ndarray, ix: np.ndarray):
    """Sampled field as JSON-ready nested lists, NaN (exterior) → null."""
    sub = field[np.ix_(iy, ix)]
    out = []
    for row in sub:
        out.append(
            [float(f"{v:.6g}") if np.isfinite(v) else None for v in row]
        )
    return out


def _full_field(results, domain, which: str) -> Optional[np.ndarray]:
    """Unpack a compacted result vector onto the (masked) grid; None if the
    results don't carry it (e.g. error when no exact solution is known).
    The unpack/mask itself is viz's (one copy of the semantics)."""
    vec = getattr(results, which, None)
    if vec is None or np.asarray(vec).size == 0:
        return None
    from iterative_solvers_tpu_torch.viz import _field_on_grid

    return _field_on_grid(results, domain, which)


def _payload(results, domain, title: str, max_cells: int) -> dict:
    nz = int(getattr(results, "nz", 0) or 0)
    # One field at a time: stats + sampled rows are extracted and the full
    # array released before the next unpack — at 8192² each f64 field is
    # ~537 MB, so holding all four at once would peak >2 GB of host RAM.
    fields = {}
    stats = {}
    ix = iy = x = y = None
    ny1 = nx1 = 0
    slice_z = None
    for key in _FIELD_KEYS:
        f = _full_field(results, domain, key)
        if f is None:
            continue
        if nz:
            zi = f.shape[0] // 2  # mid-z slice of a 3D solve
            slice_z = float(
                getattr(domain, "z0", 0.0)
                + (getattr(domain, "z1", 1.0) - getattr(domain, "z0", 0.0))
                * (zi / max(f.shape[0] - 1, 1))
            )
            f = f[zi]
        if ix is None:
            ny1, nx1 = f.shape
            ix = _sample_idx(nx1, max_cells)
            iy = _sample_idx(ny1, max_cells)
            x = np.linspace(domain.x0, domain.x1, nx1)[ix]
            y = np.linspace(domain.y0, domain.y1, ny1)[iy]
        a = np.abs(f[np.isfinite(f)])
        if a.size:
            stats[key] = {
                "min": float(a.min()),
                "max": float(a.max()),
                "avg": float(a.mean()),
            }
        fields[key] = _field_rows(f, iy, ix)
        del f, a
    if ix is None:
        raise ValueError("results carry no per-node vectors to explore")

    hist = getattr(results, "history", None)
    hist_rows = []
    if hist is not None and len(hist):
        for row in np.asarray(hist, dtype=np.float64):
            hist_rows.append(
                [None if not np.isfinite(v) else float(f"{v:.8g}") for v in row]
            )

    reason = getattr(results, "stop_reason", None)
    meta = {
        "title": title,
        "nx": int(getattr(results, "nx", 0)),
        "ny": int(getattr(results, "ny", 0)),
        "nz": nz,
        "bounds": [float(v) for v in getattr(results, "bounds", ())],
        "iterations": int(getattr(results, "iterations", 0)),
        "converged": bool(getattr(results, "converged", False)),
        "stop_reason": getattr(reason, "name", str(reason)),
        "residual_norm": float(getattr(results, "residual_norm", np.nan)),
        "error_norm": float(getattr(results, "error_norm", np.nan)),
        "precision_norm": float(getattr(results, "precision_norm", np.nan)),
        "elapsed_s": float(getattr(results, "elapsed_s", np.nan)),
        "eps": float(getattr(results, "eps", np.nan)),
        "sampled": [len(iy), len(ix)],
        "full": [ny1, nx1],
        "slice_z": slice_z,
    }
    # json round-trip of non-finite floats is invalid JSON; scrub meta too
    for k, v in list(meta.items()):
        if isinstance(v, float) and not np.isfinite(v):
            meta[k] = None

    return {
        "meta": meta,
        "x": [float(f"{v:.8g}") for v in x],
        "y": [float(f"{v:.8g}") for v in y],
        "fields": fields,
        "stats": stats,
        "history": hist_rows,
    }


def export_html(
    results,
    domain,
    path: str,
    *,
    title: str = "iterative_solvers_tpu_torch — solve explorer",
    max_cells: int = 129,
) -> str:
    """Write the standalone interactive explorer for ``results`` to ``path``.

    Returns the path. ``max_cells`` caps the embedded grid resolution per
    axis (full-field stats are unaffected). 3D results show the mid-z slice.
    """
    payload = _payload(results, domain, title, max_cells)
    data = json.dumps(payload, allow_nan=False, separators=(",", ":"))
    doc = _TEMPLATE.replace("__TITLE__", _html.escape(title)).replace(
        "__DATA__", data.replace("</", "<\\/")
    )
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(doc)
    return path


# ---------------------------------------------------------------------------
# The single-file template. Palette: the pre-validated reference instance of
# the dataviz method (categorical slots 1-4 for the convergence series; the
# one-hue sequential blue ramp for magnitude on surface/heatmap), light and
# dark both selected, text in ink tokens.
# ---------------------------------------------------------------------------

_TEMPLATE = r"""<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>__TITLE__</title>
<style>
  :root { color-scheme: light dark; }
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb; --page: #f9f9f7;
    --ink-1: #0b0b0b; --ink-2: #52514e; --ink-muted: #898781;
    --grid: #e1e0d9; --baseline: #c3c2b7;
    --border: rgba(11,11,11,0.10);
    --s1: #2a78d6; --s2: #eb6834; --s3: #1baf7a; --s4: #eda100;
    --seq-lo: #cde2fb; --seq-hi: #0d366b;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19; --page: #0d0d0d;
      --ink-1: #ffffff; --ink-2: #c3c2b7; --ink-muted: #898781;
      --grid: #2c2c2a; --baseline: #383835;
      --border: rgba(255,255,255,0.10);
      --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
    }
  }
  :root[data-theme="dark"] .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --page: #0d0d0d;
    --ink-1: #ffffff; --ink-2: #c3c2b7; --ink-muted: #898781;
    --grid: #2c2c2a; --baseline: #383835;
    --border: rgba(255,255,255,0.10);
    --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
  }
  body.viz-root {
    margin: 0; background: var(--page); color: var(--ink-1);
    font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
    font-size: 14px;
  }
  header {
    display: flex; align-items: baseline; gap: 16px; flex-wrap: wrap;
    padding: 14px 20px 0;
  }
  header h1 { font-size: 17px; font-weight: 600; margin: 0; }
  header .sub { color: var(--ink-2); font-size: 13px; }
  header .spacer { flex: 1; }
  .tabs { display: flex; gap: 4px; padding: 10px 20px 0; flex-wrap: wrap; }
  .tabs button, .chip, .theme-btn {
    border: 1px solid var(--border); background: var(--surface-1);
    color: var(--ink-2); border-radius: 7px; padding: 6px 12px;
    font: inherit; cursor: pointer;
  }
  .tabs button[aria-selected="true"] { color: var(--ink-1); font-weight: 600;
    border-color: var(--baseline); }
  .panel {
    margin: 12px 20px 20px; background: var(--surface-1);
    border: 1px solid var(--border); border-radius: 10px; padding: 14px;
  }
  .controls { display: flex; gap: 8px; align-items: center; flex-wrap: wrap;
    margin-bottom: 10px; }
  .controls .lbl { color: var(--ink-muted); font-size: 12px; }
  .chip { display: inline-flex; align-items: center; gap: 7px; }
  .chip[aria-pressed="true"] { color: var(--ink-1); border-color: var(--baseline); }
  .chip .sw { width: 10px; height: 10px; border-radius: 3px; display: inline-block; }
  .chip[aria-pressed="false"] .sw { opacity: 0.25; }
  canvas { display: block; width: 100%; border-radius: 6px; touch-action: none; }
  .hint { color: var(--ink-muted); font-size: 12px; margin-top: 8px; }
  .stats { display: flex; gap: 18px; color: var(--ink-2); font-size: 13px;
    margin-top: 8px; flex-wrap: wrap; }
  .stats b { color: var(--ink-1); font-variant-numeric: tabular-nums; font-weight: 600; }
  .tooltip {
    position: fixed; pointer-events: none; z-index: 10; display: none;
    background: var(--surface-1); color: var(--ink-1);
    border: 1px solid var(--border); border-radius: 7px;
    box-shadow: 0 2px 10px rgba(0,0,0,0.18);
    padding: 7px 10px; font-size: 12.5px; line-height: 1.5;
    font-variant-numeric: tabular-nums;
  }
  .tooltip .sw { width: 9px; height: 9px; border-radius: 3px;
    display: inline-block; margin-right: 6px; }
  .tooltip .muted { color: var(--ink-muted); }
  table { border-collapse: collapse; font-variant-numeric: tabular-nums;
    font-size: 13px; }
  th, td { text-align: right; padding: 4px 12px; border-bottom: 1px solid var(--grid); }
  th { color: var(--ink-muted); font-weight: 500; }
  td:first-child, th:first-child { text-align: left; }
  .tables { display: flex; gap: 36px; flex-wrap: wrap; align-items: flex-start; }
  .hidden { display: none !important; }
</style>
</head>
<body class="viz-root">
<header>
  <h1>__TITLE__</h1>
  <span class="sub" id="subline"></span>
  <span class="spacer"></span>
  <button class="theme-btn" id="themeBtn" title="theme">auto</button>
</header>
<div class="tabs" role="tablist" id="tabs"></div>
<div class="panel" id="panel-surface" role="tabpanel">
  <div class="controls" id="surfFields"><span class="lbl">field</span></div>
  <canvas id="surfCanvas" height="520"></canvas>
  <div class="hint">drag to rotate &middot; wheel to zoom &middot; double-click to reset</div>
  <div class="stats" id="surfStats"></div>
</div>
<div class="panel hidden" id="panel-heatmap" role="tabpanel">
  <div class="controls" id="heatFields"><span class="lbl">field</span></div>
  <canvas id="heatCanvas" height="520"></canvas>
  <div class="stats" id="heatStats"></div>
</div>
<div class="panel hidden" id="panel-scatter" role="tabpanel">
  <div class="controls" id="scatFields"><span class="lbl">quantity</span></div>
  <canvas id="scatCanvas" height="460"></canvas>
</div>
<div class="panel hidden" id="panel-convergence" role="tabpanel">
  <div class="controls" id="convSeries"></div>
  <canvas id="convCanvas" height="460"></canvas>
</div>
<div class="panel hidden" id="panel-data" role="tabpanel">
  <div class="tables"><div id="metaTable"></div><div id="histTable"></div></div>
</div>
<div class="tooltip" id="tooltip"></div>
<script type="application/json" id="data">__DATA__</script>
<script>
"use strict";
const DATA = JSON.parse(document.getElementById("data").textContent);
const tooltip = document.getElementById("tooltip");
const css = name => getComputedStyle(document.body).getPropertyValue(name).trim();

/* ---------- palette: one-hue sequential ramp (light->dark blue) ---------- */
const SEQ = ["#cde2fb","#b7d3f6","#9ec5f4","#86b6ef","#6da7ec","#5598e7",
             "#3987e5","#2a78d6","#256abf","#1c5cab","#184f95","#104281","#0d366b"];
function hex2rgb(h){return [parseInt(h.slice(1,3),16),parseInt(h.slice(3,5),16),parseInt(h.slice(5,7),16)];}
const SEQ_RGB = SEQ.map(hex2rgb);
function seqColor(t){            // t in [0,1] -> css color along the ramp
  if (!isFinite(t)) t = 0; t = Math.min(1, Math.max(0, t));
  const u = t * (SEQ_RGB.length - 1), i = Math.min(SEQ_RGB.length - 2, Math.floor(u)), f = u - i;
  const a = SEQ_RGB[i], b = SEQ_RGB[i+1];
  return `rgb(${Math.round(a[0]+f*(b[0]-a[0]))},${Math.round(a[1]+f*(b[1]-a[1]))},${Math.round(a[2]+f*(b[2]-a[2]))})`;
}
const FIELD_LABEL = {solution:"numeric solution", true_solution:"true solution",
                     error:"error", residual:"residual"};
const fmt = v => v == null ? "–" : (Math.abs(v) !== 0 && (Math.abs(v) < 1e-3 || Math.abs(v) >= 1e4))
  ? v.toExponential(3) : (+v.toPrecision(5)).toString();

/* ---------- shared canvas scaffolding ---------- */
function fitCanvas(cv){
  const dpr = window.devicePixelRatio || 1;
  const w = cv.clientWidth || cv.parentElement.clientWidth - 28;
  const h = parseInt(cv.getAttribute("height"), 10);
  cv.width = Math.round(w * dpr); cv.height = Math.round(h * dpr);
  cv.style.height = h + "px";
  const ctx = cv.getContext("2d");
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  return [ctx, w, h];
}
function showTip(px, py, html){
  tooltip.innerHTML = html; tooltip.style.display = "block";
  const r = tooltip.getBoundingClientRect();
  let x = px + 14, y = py + 14;
  if (x + r.width > window.innerWidth - 8) x = px - r.width - 14;
  if (y + r.height > window.innerHeight - 8) y = py - r.height - 14;
  tooltip.style.left = x + "px"; tooltip.style.top = y + "px";
}
function hideTip(){ tooltip.style.display = "none"; }
function fieldChips(holder, onPick){
  const keys = Object.keys(DATA.fields);
  keys.forEach((k, i) => {
    const b = document.createElement("button");
    b.className = "chip"; b.textContent = FIELD_LABEL[k] || k;
    b.setAttribute("aria-pressed", i === 0 ? "true" : "false");
    b.onclick = () => {
      holder.querySelectorAll(".chip").forEach(c => c.setAttribute("aria-pressed", "false"));
      b.setAttribute("aria-pressed", "true");
      onPick(k);
    };
    holder.appendChild(b);
  });
}

/* ---------- tabs ---------- */
const TABS = [["surface","Surface"],["heatmap","Heatmap"],["scatter","Scatter"],
              ["convergence","Convergence"],["data","Data"]];
const tabBar = document.getElementById("tabs");
const renderers = {};                     // tab -> redraw()
let currentTab = "surface";
TABS.forEach(([id, label], i) => {
  const b = document.createElement("button");
  b.textContent = label; b.setAttribute("role","tab");
  b.setAttribute("aria-selected", i === 0 ? "true" : "false");
  b.onclick = () => {
    currentTab = id;
    tabBar.querySelectorAll("button").forEach(x => x.setAttribute("aria-selected","false"));
    b.setAttribute("aria-selected","true");
    TABS.forEach(([tid]) => document.getElementById("panel-"+tid)
      .classList.toggle("hidden", tid !== id));
    hideTip();
    if (renderers[id]) renderers[id]();
  };
  tabBar.appendChild(b);
});

/* ---------- header subline & theme toggle ---------- */
const M = DATA.meta;
document.getElementById("subline").textContent =
  `${M.nx}×${M.ny}${M.nz ? "×"+M.nz : ""} grid · ` +
  `${M.iterations} iterations · ${M.converged ? "converged" : "not converged"}` +
  ` (${M.stop_reason})` +
  (M.elapsed_s != null ? ` · ${M.elapsed_s.toFixed(3)} s` : "") +
  (M.nz ? ` · showing z=${fmt(M.slice_z)} slice` : "");
const themeBtn = document.getElementById("themeBtn");
const THEMES = ["auto","light","dark"]; let themeIdx = 0;
themeBtn.onclick = () => {
  themeIdx = (themeIdx + 1) % 3;
  const t = THEMES[themeIdx]; themeBtn.textContent = t;
  if (t === "auto") document.documentElement.removeAttribute("data-theme");
  else document.documentElement.setAttribute("data-theme", t);
  if (renderers[currentTab]) renderers[currentTab]();
};

/* ---------- field helpers ---------- */
const X = DATA.x, Y = DATA.y, NX = X.length, NY = Y.length;
function fieldRange(f){
  let lo = Infinity, hi = -Infinity;
  for (const row of DATA.fields[f]) for (const v of row)
    if (v != null) { if (v < lo) lo = v; if (v > hi) hi = v; }
  if (!(hi > lo)) hi = lo + 1;
  return [lo, hi];
}

/* =================== Surface (rotatable 3D) =================== */
(function(){
  const cv = document.getElementById("surfCanvas");
  let field = Object.keys(DATA.fields)[0];
  let yaw = -0.65, pitch = 0.42, zoom = 1.0;
  fieldChips(document.getElementById("surfFields"), k => { field = k; draw(); });

  function draw(){
    const [ctx, w, h] = fitCanvas(cv);
    ctx.clearRect(0, 0, w, h);
    const F = DATA.fields[field];
    const [lo, hi] = fieldRange(field);
    const cy = Math.cos(yaw), sy = Math.sin(yaw);
    const cp = Math.cos(pitch), sp = Math.sin(pitch);
    const scale = Math.min(w, h) * 0.42 * zoom;
    const cx0 = w / 2, cy0 = h / 2 + scale * 0.12;
    const xs = X[0], xw = X[NX-1] - xs || 1, ys = Y[0], yw = Y[NY-1] - ys || 1;
    const zh = 0.8;                        // height budget in unit-cube terms
    function proj(ix, iy, v){
      const ux = (X[ix] - xs) / xw - 0.5, uy = (Y[iy] - ys) / yw - 0.5;
      const uz = ((v - lo) / (hi - lo) - 0.5) * zh;
      const rx = ux * cy - uy * sy, ry = ux * sy + uy * cy;
      const sx = cx0 + rx * scale;
      const syc = cy0 + (ry * cp - uz * sp) * scale * 0.9;
      // rigid rotation + orthographic along depth => painter's sort is exact
      const depth = ry * sp + uz * cp;      // larger = nearer
      return [sx, syc, depth];
    }
    // quads with painter's algorithm
    const quads = [];
    for (let j = 0; j < NY - 1; j++){
      for (let i = 0; i < NX - 1; i++){
        const v00 = F[j][i], v01 = F[j][i+1], v10 = F[j+1][i], v11 = F[j+1][i+1];
        if (v00 == null || v01 == null || v10 == null || v11 == null) continue;
        const p00 = proj(i, j, v00), p01 = proj(i+1, j, v01),
              p10 = proj(i, j+1, v10), p11 = proj(i+1, j+1, v11);
        const zm = (v00 + v01 + v10 + v11) / 4;
        quads.push([ (p00[2]+p01[2]+p10[2]+p11[2])/4, p00, p01, p11, p10,
                     (zm - lo) / (hi - lo) ]);
      }
    }
    quads.sort((a, b) => a[0] - b[0]);
    const gap = css("--surface-1");
    for (const q of quads){
      ctx.beginPath();
      ctx.moveTo(q[1][0], q[1][1]); ctx.lineTo(q[2][0], q[2][1]);
      ctx.lineTo(q[3][0], q[3][1]); ctx.lineTo(q[4][0], q[4][1]);
      ctx.closePath();
      ctx.fillStyle = seqColor(0.15 + 0.85 * q[5]);
      ctx.strokeStyle = gap; ctx.lineWidth = 0.5;
      ctx.fill(); ctx.stroke();
    }
    // axis triad at the front-bottom corner
    ctx.strokeStyle = css("--baseline"); ctx.lineWidth = 1;
    ctx.fillStyle = css("--ink-muted"); ctx.font = "12px system-ui";
    const o = proj(0, 0, lo), ax = proj(NX-1, 0, lo), ay = proj(0, NY-1, lo);
    ctx.beginPath(); ctx.moveTo(o[0], o[1]); ctx.lineTo(ax[0], ax[1]);
    ctx.moveTo(o[0], o[1]); ctx.lineTo(ay[0], ay[1]); ctx.stroke();
    ctx.fillText("x", ax[0] + 6, ax[1]); ctx.fillText("y", ay[0] + 6, ay[1]);
    const st = document.getElementById("surfStats");
    st.innerHTML = `<span>${FIELD_LABEL[field]}</span>` +
      `<span>min <b>${fmt(lo)}</b></span><span>max <b>${fmt(hi)}</b></span>`;
  }
  let drag = null;
  cv.addEventListener("pointerdown", e => { drag = [e.clientX, e.clientY]; cv.setPointerCapture(e.pointerId); });
  cv.addEventListener("pointermove", e => {
    if (!drag) return;
    yaw += (e.clientX - drag[0]) * 0.008;
    pitch = Math.min(1.4, Math.max(0.05, pitch + (e.clientY - drag[1]) * 0.006));
    drag = [e.clientX, e.clientY]; draw();
  });
  cv.addEventListener("pointerup", () => drag = null);
  cv.addEventListener("wheel", e => {
    e.preventDefault();
    zoom = Math.min(4, Math.max(0.3, zoom * (e.deltaY < 0 ? 1.1 : 0.9))); draw();
  }, {passive: false});
  cv.addEventListener("dblclick", () => { yaw = -0.65; pitch = 0.42; zoom = 1.0; draw(); });
  renderers.surface = draw;
})();

/* =================== Heatmap (hover readout) =================== */
(function(){
  const cv = document.getElementById("heatCanvas");
  let field = Object.keys(DATA.fields)[0];
  let geom = null;
  fieldChips(document.getElementById("heatFields"), k => { field = k; draw(); });

  function draw(){
    const [ctx, w, h] = fitCanvas(cv);
    ctx.clearRect(0, 0, w, h);
    const F = DATA.fields[field];
    // |value| for magnitude (the reference heatmap shows |error|)
    let lo = Infinity, hi = -Infinity;
    for (const row of F) for (const v of row) if (v != null){
      const a = Math.abs(v); if (a < lo) lo = a; if (a > hi) hi = a;
    }
    if (!(hi > lo)) hi = lo + 1;
    const pad = 44, pw = w - pad - 70, ph = h - pad - 10;
    const cellW = pw / NX, cellH = ph / NY;
    geom = {pad, cellW, cellH, ph, lo, hi};
    for (let j = 0; j < NY; j++){
      for (let i = 0; i < NX; i++){
        const v = F[j][i]; if (v == null) continue;
        ctx.fillStyle = seqColor((Math.abs(v) - lo) / (hi - lo));
        ctx.fillRect(pad + i * cellW, 10 + ph - (j + 1) * cellH,
                     Math.ceil(cellW), Math.ceil(cellH));
      }
    }
    // axes
    ctx.strokeStyle = css("--baseline"); ctx.lineWidth = 1;
    ctx.strokeRect(pad, 10, pw, ph);
    ctx.fillStyle = css("--ink-muted"); ctx.font = "11px system-ui";
    ctx.textAlign = "center";
    ctx.fillText(fmt(X[0]), pad, h - 22); ctx.fillText(fmt(X[NX-1]), pad + pw, h - 22);
    ctx.fillText("x", pad + pw / 2, h - 8);
    ctx.textAlign = "right";
    ctx.fillText(fmt(Y[0]), pad - 6, 10 + ph); ctx.fillText(fmt(Y[NY-1]), pad - 6, 18);
    ctx.save(); ctx.translate(12, 10 + ph / 2); ctx.rotate(-Math.PI / 2);
    ctx.textAlign = "center"; ctx.fillText("y", 0, 0); ctx.restore();
    // color legend bar
    const lx = pad + pw + 18, lh = ph * 0.8, ly = 10 + (ph - lh) / 2;
    for (let t = 0; t < lh; t++){
      ctx.fillStyle = seqColor(1 - t / lh);
      ctx.fillRect(lx, ly + t, 12, 1.5);
    }
    ctx.strokeStyle = css("--border"); ctx.strokeRect(lx, ly, 12, lh);
    ctx.textAlign = "left"; ctx.fillStyle = css("--ink-muted");
    ctx.fillText(fmt(hi), lx + 16, ly + 8); ctx.fillText(fmt(lo), lx + 16, ly + lh);
    const s = DATA.stats[field] || {};
    document.getElementById("heatStats").innerHTML =
      `<span>|${FIELD_LABEL[field]}| on the full ${M.full[1]}×${M.full[0]} grid:</span>` +
      `<span>min <b>${fmt(s.min)}</b></span><span>max <b>${fmt(s.max)}</b></span>` +
      `<span>avg <b>${fmt(s.avg)}</b></span>`;
    ctx.textAlign = "left";
  }
  cv.addEventListener("pointermove", e => {
    if (!geom) return;
    const r = cv.getBoundingClientRect();
    const mx = e.clientX - r.left, my = e.clientY - r.top;
    const i = Math.floor((mx - geom.pad) / geom.cellW);
    const j = Math.floor((10 + geom.ph - my) / geom.cellH);
    const v = (i >= 0 && i < NX && j >= 0 && j < NY) ? DATA.fields[field][j][i] : null;
    if (v == null) { hideTip(); return; }
    showTip(e.clientX, e.clientY,
      `<span class="muted">x</span> ${fmt(X[i])} &nbsp;` +
      `<span class="muted">y</span> ${fmt(Y[j])}<br>` +
      `${FIELD_LABEL[field]}: <b>${fmt(v)}</b>`);
  });
  cv.addEventListener("pointerleave", hideTip);
  renderers.heatmap = draw;
})();

/* =================== Scatter (quantity vs x) =================== */
(function(){
  const cv = document.getElementById("scatCanvas");
  let field = Object.keys(DATA.fields)[0];
  let pts = [];
  fieldChips(document.getElementById("scatFields"), k => { field = k; draw(); });

  function draw(){
    const [ctx, w, h] = fitCanvas(cv);
    ctx.clearRect(0, 0, w, h);
    const F = DATA.fields[field];
    const absMode = field === "error" || field === "residual";
    let lo = Infinity, hi = -Infinity;
    pts = [];
    for (let j = 0; j < NY; j++) for (let i = 0; i < NX; i++){
      let v = F[j][i]; if (v == null) continue;
      if (absMode) v = Math.abs(v);
      pts.push([X[i], v, Y[j]]);
      if (v < lo) lo = v; if (v > hi) hi = v;
    }
    if (!(hi > lo)) hi = lo + 1;
    const pad = 64, pw = w - pad - 16, ph = h - 46;
    const xs = X[0], xw = (X[NX-1] - xs) || 1;
    const px = v => pad + (v - xs) / xw * pw;
    const py = v => 10 + ph - (v - lo) / (hi - lo) * ph;
    ctx.strokeStyle = css("--grid"); ctx.lineWidth = 1;
    ctx.fillStyle = css("--ink-muted"); ctx.font = "11px system-ui"; ctx.textAlign = "right";
    for (let t = 0; t <= 4; t++){
      const v = lo + (hi - lo) * t / 4, yy = py(v);
      ctx.beginPath(); ctx.moveTo(pad, yy); ctx.lineTo(pad + pw, yy); ctx.stroke();
      ctx.fillText(fmt(v), pad - 8, yy + 4);
    }
    ctx.textAlign = "center";
    for (let t = 0; t <= 5; t++){
      const v = xs + xw * t / 5;
      ctx.fillText(fmt(v), px(v), h - 18);
    }
    ctx.fillText("x", pad + pw / 2, h - 4);
    ctx.strokeStyle = css("--baseline");
    ctx.beginPath(); ctx.moveTo(pad, 10); ctx.lineTo(pad, 10 + ph);
    ctx.lineTo(pad + pw, 10 + ph); ctx.stroke();
    ctx.fillStyle = css("--s1"); ctx.globalAlpha = 0.55;
    for (const p of pts){
      ctx.beginPath(); ctx.arc(px(p[0]), py(p[1]), 2.2, 0, 6.3); ctx.fill();
    }
    ctx.globalAlpha = 1;
    geomS = {px, py};
  }
  let geomS = null;
  cv.addEventListener("pointermove", e => {
    if (!geomS || !pts.length) return;
    const r = cv.getBoundingClientRect();
    const mx = e.clientX - r.left, my = e.clientY - r.top;
    let best = null, bd = 144;             // 12px hit radius
    for (const p of pts){
      const dx = geomS.px(p[0]) - mx, dy = geomS.py(p[1]) - my, d = dx*dx + dy*dy;
      if (d < bd) { bd = d; best = p; }
    }
    if (!best) { hideTip(); return; }
    showTip(e.clientX, e.clientY,
      `<span class="muted">x</span> ${fmt(best[0])} &nbsp;` +
      `<span class="muted">y</span> ${fmt(best[2])}<br>` +
      `${FIELD_LABEL[field]}: <b>${fmt(best[1])}</b>`);
  });
  cv.addEventListener("pointerleave", hideTip);
  renderers.scatter = draw;
})();

/* =================== Convergence (log10 lines) =================== */
(function(){
  const cv = document.getElementById("convCanvas");
  const SERIES = [
    {col: 1, name: "precision ‖Δx‖∞", v: "--s1"},
    {col: 2, name: "residual ‖r‖∞",  v: "--s2"},
    {col: 3, name: "error ‖x−u‖∞", v: "--s3"},
    {col: 4, name: "residual ‖r‖₂",  v: "--s4"},
  ];
  const H = DATA.history || [];
  const on = new Set(SERIES.map(s => s.col));
  const holder = document.getElementById("convSeries");
  const seriesHasData = s => H.some(row => row[s.col] != null && row[s.col] > 0);
  SERIES.filter(seriesHasData).forEach(s => {
    const b = document.createElement("button");
    b.className = "chip"; b.setAttribute("aria-pressed", "true");
    b.innerHTML = `<span class="sw" style="background:var(${s.v})"></span>${s.name}`;
    b.onclick = () => {
      if (on.has(s.col)) on.delete(s.col); else on.add(s.col);
      b.setAttribute("aria-pressed", on.has(s.col) ? "true" : "false");
      draw();
    };
    holder.appendChild(b);
  });
  let geomC = null;
  function draw(){
    const [ctx, w, h] = fitCanvas(cv);
    ctx.clearRect(0, 0, w, h);
    if (!H.length){
      ctx.fillStyle = css("--ink-muted"); ctx.font = "13px system-ui";
      ctx.fillText("no recorded convergence history", 20, 40);
      geomC = null; return;
    }
    const act = SERIES.filter(s => on.has(s.col) && seriesHasData(s));
    let lo = Infinity, hi = -Infinity, kmax = 1;
    for (const row of H){
      kmax = Math.max(kmax, row[0] || 0);
      for (const s of act){
        const v = row[s.col];
        if (v != null && v > 0){ const l = Math.log10(v); if (l < lo) lo = l; if (l > hi) hi = l; }
      }
    }
    if (!isFinite(lo)) { lo = -1; hi = 1; }
    if (hi - lo < 1e-9) hi = lo + 1;
    const pad = 56, pw = w - pad - 130, ph = h - 46;
    const px = k => pad + k / kmax * pw;
    const py = l => 10 + ph - (l - lo) / (hi - lo) * ph;
    ctx.strokeStyle = css("--grid"); ctx.lineWidth = 1;
    ctx.fillStyle = css("--ink-muted"); ctx.font = "11px system-ui";
    ctx.textAlign = "right";
    const l0 = Math.ceil(lo), l1 = Math.floor(hi);
    const step = Math.max(1, Math.round((l1 - l0) / 6));
    for (let l = l0; l <= l1; l += step){
      ctx.beginPath(); ctx.moveTo(pad, py(l)); ctx.lineTo(pad + pw, py(l)); ctx.stroke();
      ctx.fillText("1e" + l, pad - 8, py(l) + 4);
    }
    ctx.textAlign = "center";
    for (let t = 0; t <= 5; t++){
      const k = Math.round(kmax * t / 5);
      ctx.fillText(k, px(k), h - 18);
    }
    ctx.fillText("iteration", pad + pw / 2, h - 4);
    ctx.strokeStyle = css("--baseline");
    ctx.beginPath(); ctx.moveTo(pad, 10); ctx.lineTo(pad, 10 + ph);
    ctx.lineTo(pad + pw, 10 + ph); ctx.stroke();
    for (const s of act){
      ctx.strokeStyle = css(s.v); ctx.lineWidth = 2;
      ctx.beginPath(); let pen = false, last = null;
      for (const row of H){
        const v = row[s.col];
        if (v == null || v <= 0){ pen = false; continue; }
        const xx = px(row[0] || 0), yy = py(Math.log10(v));
        if (pen) ctx.lineTo(xx, yy); else ctx.moveTo(xx, yy);
        pen = true; last = [xx, yy];
      }
      ctx.stroke();
      if (last){                        // direct end label: dot + ink text
        ctx.fillStyle = css(s.v);
        ctx.beginPath(); ctx.arc(last[0], last[1], 3, 0, 6.3); ctx.fill();
        ctx.fillStyle = css("--ink-2"); ctx.textAlign = "left";
        ctx.font = "11px system-ui";
        ctx.fillText(s.name.split(" ")[0], last[0] + 8, last[1] + 4);
      }
    }
    geomC = {px, py, kmax, pad, pw, ph, act};
  }
  cv.addEventListener("pointermove", e => {
    if (!geomC || !H.length) return;
    const r = cv.getBoundingClientRect();
    const mx = e.clientX - r.left;
    let best = null, bd = Infinity;
    for (const row of H){
      const d = Math.abs(geomC.px(row[0] || 0) - mx);
      if (d < bd){ bd = d; best = row; }
    }
    if (!best || bd > 40){ hideTip(); return; }
    // crosshair
    draw();
    const ctx = cv.getContext("2d");
    ctx.strokeStyle = css("--baseline"); ctx.lineWidth = 1;
    ctx.setLineDash([4, 3]);
    const xx = geomC.px(best[0] || 0);
    ctx.beginPath(); ctx.moveTo(xx, 10); ctx.lineTo(xx, 10 + geomC.ph); ctx.stroke();
    ctx.setLineDash([]);
    let htmlRows = `<span class="muted">iteration ${best[0]}</span>`;
    for (const s of geomC.act){
      const v = best[s.col];
      if (v == null) continue;
      htmlRows += `<br><span class="sw" style="background:var(${s.v})"></span>` +
                  `${s.name}: <b>${v.toExponential(3)}</b>`;
    }
    showTip(e.clientX, e.clientY, htmlRows);
  });
  cv.addEventListener("pointerleave", () => { hideTip(); draw(); });
  renderers.convergence = draw;
})();

/* =================== Data (tables) =================== */
(function(){
  const rows = [
    ["grid", `${M.nx} × ${M.ny}` + (M.nz ? ` × ${M.nz}` : "")],
    ["bounds", (M.bounds || []).map(fmt).join(", ")],
    ["iterations", M.iterations],
    ["converged", String(M.converged)],
    ["stop reason", M.stop_reason],
    ["‖r‖∞", fmt(M.residual_norm)],
    ["‖x−u‖∞", fmt(M.error_norm)],
    ["‖Δx‖∞", fmt(M.precision_norm)],
    ["eps", fmt(M.eps)],
    ["elapsed [s]", fmt(M.elapsed_s)],
    ["embedded samples", `${M.sampled[1]} × ${M.sampled[0]} of ${M.full[1]} × ${M.full[0]}`],
  ];
  document.getElementById("metaTable").innerHTML =
    "<table><thead><tr><th>run</th><th></th></tr></thead><tbody>" +
    rows.map(r => `<tr><td>${r[0]}</td><td>${r[1]}</td></tr>`).join("") +
    "</tbody></table>";
  const H = DATA.history || [];
  if (H.length){
    document.getElementById("histTable").innerHTML =
      "<table><thead><tr><th>iter</th><th>‖Δx‖∞</th>" +
      "<th>‖r‖∞</th><th>‖x−u‖∞</th>" +
      "<th>‖r‖₂</th></tr></thead><tbody>" +
      H.map(row => "<tr>" + row.map((v, i) =>
        `<td>${i === 0 ? (v == null ? "–" : v) : (v == null ? "–" : v.toExponential(3))}</td>`
      ).join("") + "</tr>").join("") + "</tbody></table>";
  }
})();

renderers.surface();
window.addEventListener("resize", () => { if (renderers[currentTab]) renderers[currentTab](); });
</script>
</body>
</html>
"""
