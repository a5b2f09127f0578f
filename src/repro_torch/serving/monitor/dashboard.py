"""Self-contained HTML ops dashboard for a monitored run (stdlib only).

Like ``scripts/plot_frontier.py``, this renders with nothing but string
formatting: one portable ``.html`` file with inline SVG, no JS, no CDN —
CI uploads it as an artifact next to the frontier SVG and it opens
anywhere.  Panels:

  * **signal timelines** — traffic / drops, per-class p95 TTFT, fleet
    power and lost joules, J/token and gCO2/token, per-zone carbon
    intensity — one polyline per series over the sealed monitor windows,
    with incident ribbons (page = red, warn = amber) shaded behind every
    chart;
  * **budget burn-down** — remaining budget fraction per
    :class:`~repro_torch.serving.monitor.burnrate.BudgetSpec` over time, plus
    the slow-window burn rate;
  * **incident table** — start/end, severity, budgets fired, affected
    endpoints, joules lost while open;
  * **per-phase breakdown** — the report's
    ``queue_wait/prefill/xfer/decode/preempted`` p50/p95 table.
"""

from __future__ import annotations

import html
from typing import Dict, List, Optional, Sequence, Tuple

_W, _H = 720, 130
_PAD_L, _PAD_R, _PAD_T, _PAD_B = 58, 14, 18, 22
_PALETTE = ("#2563eb", "#059669", "#d97706", "#dc2626", "#7c3aed",
            "#0891b2", "#be185d", "#4d7c0f")
_RIBBON = {"page": "#dc262622", "warn": "#d9770622"}
_PHASES = ("queue_wait", "prefill", "xfer", "decode", "preempted")

_CSS = """
body { font: 13px/1.45 system-ui, sans-serif; margin: 24px auto;
       max-width: 820px; color: #1f2937; }
h1 { font-size: 19px; } h2 { font-size: 15px; margin: 26px 0 6px; }
svg { display: block; }
table { border-collapse: collapse; margin: 8px 0; font-size: 12px; }
th, td { border: 1px solid #d1d5db; padding: 3px 8px; text-align: right; }
th { background: #f3f4f6; } td:first-child, th:first-child { text-align: left; }
.page { color: #dc2626; font-weight: 600; }
.warn { color: #d97706; font-weight: 600; }
.ok   { color: #059669; font-weight: 600; }
.meta { color: #6b7280; font-size: 12px; }
"""


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    if abs(v) >= 1:
        return f"{v:.3g}"
    return f"{v:.3g}"


def _poly(points: Sequence[Tuple[float, float]], t0: float, t1: float,
          ymax: float, color: str) -> str:
    if not points or t1 <= t0 or ymax <= 0:
        return ""
    span_x = _W - _PAD_L - _PAD_R
    span_y = _H - _PAD_T - _PAD_B
    coords = " ".join(
        f"{_PAD_L + (t - t0) / (t1 - t0) * span_x:.1f},"
        f"{_PAD_T + span_y - min(v, ymax) / ymax * span_y:.1f}"
        for t, v in points)
    return (f'<polyline points="{coords}" fill="none" stroke="{color}" '
            f'stroke-width="1.4"/>')


def _chart(title: str, series: Sequence[Tuple[str, List[Tuple[float, float]]]],
           t0: float, t1: float, incidents: Sequence[dict]) -> str:
    ymax = 0.0
    for _, pts in series:
        for _, v in pts:
            ymax = max(ymax, v)
    ymax = ymax * 1.08 or 1.0
    span_x = _W - _PAD_L - _PAD_R
    span_y = _H - _PAD_T - _PAD_B
    out = [f'<svg width="{_W}" height="{_H}" '
           f'viewBox="0 0 {_W} {_H}" role="img">']
    out.append(f'<text x="{_PAD_L}" y="12" font-size="12" '
               f'fill="#374151">{html.escape(title)}</text>')
    # incident ribbons behind everything
    for inc in incidents:
        if t1 <= t0:
            continue
        x0 = _PAD_L + max(0.0, (inc["start"] - t0) / (t1 - t0)) * span_x
        x1 = _PAD_L + min(1.0, (inc["end"] - t0) / (t1 - t0)) * span_x
        fill = _RIBBON.get(inc["severity"], _RIBBON["warn"])
        out.append(f'<rect x="{x0:.1f}" y="{_PAD_T}" '
                   f'width="{max(x1 - x0, 1.0):.1f}" height="{span_y}" '
                   f'fill="{fill}"/>')
    # frame + y max label
    out.append(f'<rect x="{_PAD_L}" y="{_PAD_T}" width="{span_x}" '
               f'height="{span_y}" fill="none" stroke="#e5e7eb"/>')
    out.append(f'<text x="{_PAD_L - 6}" y="{_PAD_T + 8}" font-size="10" '
               f'fill="#6b7280" text-anchor="end">{_fmt(ymax)}</text>')
    out.append(f'<text x="{_PAD_L - 6}" y="{_H - _PAD_B}" font-size="10" '
               f'fill="#6b7280" text-anchor="end">0</text>')
    out.append(f'<text x="{_PAD_L}" y="{_H - 6}" font-size="10" '
               f'fill="#6b7280">t={_fmt(t0)}s</text>')
    out.append(f'<text x="{_W - _PAD_R}" y="{_H - 6}" font-size="10" '
               f'fill="#6b7280" text-anchor="end">t={_fmt(t1)}s</text>')
    legend_x = _PAD_L
    for i, (label, pts) in enumerate(series):
        color = _PALETTE[i % len(_PALETTE)]
        out.append(_poly(pts, t0, t1, ymax, color))
        out.append(f'<rect x="{legend_x}" y="{_H - 16}" width="8" '
                   f'height="8" fill="{color}"/>')
        out.append(f'<text x="{legend_x + 11}" y="{_H - 8}" font-size="10" '
                   f'fill="#374151">{html.escape(label)}</text>')
        legend_x += 18 + 6 * len(label)
    out.append("</svg>")
    return "".join(out)


def _series(windows: Sequence[dict], getter) -> List[Tuple[float, float]]:
    return [((w["t0"] + w["t1"]) / 2.0, getter(w)) for w in windows]


def _gauge_series(windows: Sequence[dict],
                  prefix: str) -> Dict[str, List[Tuple[float, float]]]:
    """Deduped gauges carried forward so flat series still draw."""
    names = sorted({s for w in windows for s in w["gauges"]
                    if s.startswith(prefix)})
    out: Dict[str, List[Tuple[float, float]]] = {n: [] for n in names}
    last: Dict[str, float] = {}
    for w in windows:
        t = (w["t0"] + w["t1"]) / 2.0
        for n in names:
            if n in w["gauges"]:
                last[n] = w["gauges"][n]
            if n in last:
                out[n].append((t, last[n]))
    return out


def _incident_rows(incidents: Sequence[dict]) -> str:
    if not incidents:
        return '<p class="ok">no incidents detected</p>'
    rows = ["<table><tr><th>#</th><th>start (s)</th><th>end (s)</th>"
            "<th>severity</th><th>budgets</th><th>endpoints</th>"
            "<th>alerts</th><th>lost J</th></tr>"]
    for i, inc in enumerate(incidents):
        rows.append(
            f'<tr><td>{i}</td><td>{inc["start"]:.2f}</td>'
            f'<td>{inc["end"]:.2f}</td>'
            f'<td class="{inc["severity"]}">{inc["severity"]}</td>'
            f'<td>{html.escape(", ".join(inc["budgets"]))}</td>'
            f'<td>{html.escape(", ".join(inc["endpoints"]))}</td>'
            f'<td>{inc["alerts"]}</td><td>{_fmt(inc["lost_j"])}</td></tr>')
    rows.append("</table>")
    return "".join(rows)


def _budget_rows(remaining: Dict[str, dict]) -> str:
    if not remaining:
        return '<p class="meta">no budgets declared</p>'
    rows = ["<table><tr><th>budget</th><th>kind</th><th>allowance</th>"
            "<th>spent</th><th>remaining</th><th>remaining %</th></tr>"]
    for name in sorted(remaining):
        r = remaining[name]
        cls = "ok" if r["remaining_frac"] > 0.25 else \
            ("warn" if r["remaining_frac"] > 0 else "page")
        rows.append(
            f"<tr><td>{html.escape(name)}</td><td>{r['kind']}</td>"
            f"<td>{_fmt(r['budget'])}</td><td>{_fmt(r['spent'])}</td>"
            f"<td>{_fmt(r['remaining'])}</td>"
            f"<td class=\"{cls}\">{r['remaining_frac'] * 100:.1f}%</td>"
            f"</tr>")
    rows.append("</table>")
    return "".join(rows)


def _phase_rows(phase_breakdown: Dict[str, dict]) -> str:
    rows = ["<table><tr><th>class</th><th>phase</th><th>n</th>"
            "<th>mean (ms)</th><th>p50 (ms)</th><th>p95 (ms)</th></tr>"]
    for cls in sorted(phase_breakdown):
        for ph in _PHASES:
            row = phase_breakdown[cls].get(ph)
            if row is None:
                continue
            rows.append(
                f"<tr><td>{html.escape(cls)}</td><td>{ph}</td>"
                f"<td>{row['n']}</td><td>{row['mean_s'] * 1e3:.2f}</td>"
                f"<td>{row['p50_s'] * 1e3:.2f}</td>"
                f"<td>{row['p95_s'] * 1e3:.2f}</td></tr>")
    rows.append("</table>")
    return "".join(rows)


def render_dashboard(monitor, title: str = "green serving ops",
                     phase_breakdown: Optional[Dict[str, dict]] = None,
                     meta: Optional[Dict[str, str]] = None) -> str:
    """One self-contained HTML page for a finalized monitor runtime."""
    windows = monitor.windows
    incidents = monitor.incidents
    alerts = monitor.alerts
    t0 = windows[0]["t0"] if windows else 0.0
    t1 = windows[-1]["t1"] if windows else 1.0
    classes = sorted({c for w in windows for c in w["classes"]})
    budgets = sorted({b for w in windows for b in w.get("burn", {})})
    span = windows[0]["t1"] - windows[0]["t0"] if windows else 1.0

    charts = []
    charts.append(_chart(
        "traffic (req/s) and failures", [
            ("served/s", _series(windows, lambda w: w["served"] / span)),
            ("drops/s", _series(windows, lambda w: w["drops"] / span)),
            ("sheds/s", _series(windows, lambda w: w["sheds"] / span)),
            ("retries/s", _series(windows, lambda w: w["retries"] / span)),
        ], t0, t1, incidents))
    charts.append(_chart(
        "p95 TTFT per SLO class (ms)",
        [(cls, _series(windows,
                       lambda w, c=cls: w["classes"].get(
                           c, {}).get("p95_ttft_s", 0.0) * 1e3))
         for cls in classes], t0, t1, incidents))
    charts.append(_chart(
        "fleet power (W) and lost J per window", [
            ("watts", _series(windows, lambda w: w["watts"])),
            ("lost J", _series(windows, lambda w: w["lost_j"])),
        ], t0, t1, incidents))
    charts.append(_chart(
        "energy intensity per token", [
            ("J/token", _series(windows, lambda w: w["j_per_token"])),
            ("mgCO2/token",
             _series(windows, lambda w: w["g_per_token"] * 1e3)),
        ], t0, t1, incidents))
    zones = _gauge_series(windows, "zone/")
    if not zones:
        zones = _gauge_series(windows, "grid/")
    if zones:
        charts.append(_chart(
            "carbon intensity (gCO2/kWh)",
            [(name.split("/")[1] if "/" in name else name, pts)
             for name, pts in sorted(zones.items())], t0, t1, incidents))
    if budgets:
        charts.append(_chart(
            "burn rate (slow window)",
            [(b, _series(windows,
                         lambda w, b=b: w.get("burn", {}).get(
                             b, (0.0, 0.0))[1]))
             for b in budgets], t0, t1, incidents))
        charts.append(_chart(
            "budget remaining (fraction)",
            [(b, _series(windows,
                         lambda w, b=b: max(
                             0.0, w.get("remaining", {}).get(b, 1.0))))
             for b in budgets], t0, t1, incidents))

    pages = sum(1 for a in alerts if a["severity"] == "page")
    warns = len(alerts) - pages
    meta_bits = [f"{len(windows)} windows x {span:.3g}s",
                 f"{pages} page / {warns} warn alerts",
                 f"{len(incidents)} incidents"]
    for k in sorted(meta or {}):
        meta_bits.append(f"{k}={meta[k]}")

    parts = ["<!DOCTYPE html><html><head><meta charset='utf-8'>",
             f"<title>{html.escape(title)}</title>",
             f"<style>{_CSS}</style></head><body>",
             f"<h1>{html.escape(title)}</h1>",
             f'<p class="meta">{html.escape(" · ".join(meta_bits))}</p>',
             "<h2>Signals</h2>", *charts,
             "<h2>Budgets</h2>", _budget_rows(monitor.budget_remaining()),
             "<h2>Incidents</h2>", _incident_rows(incidents)]
    if phase_breakdown:
        parts += ["<h2>Phase breakdown</h2>", _phase_rows(phase_breakdown)]
    parts.append("</body></html>")
    return "".join(parts)


def write_dashboard(path: str, monitor, **kwargs) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_dashboard(monitor, **kwargs))
