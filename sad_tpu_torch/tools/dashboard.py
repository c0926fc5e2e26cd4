"""Training-run dashboard: a static HTML report over an output directory (a
copy of sad_tpu/tools/dashboard.py).

The analogue of the reference's mint web UI (caffe2/python/mint/app.py, a
Flask app that browses workspace blobs and nets): there is no live
workspace here, so what a human browses is a RUN: its stats stream,
checkpoints and configs. This tool renders an output directory (as
train_net writes it) into one standalone HTML file of small-multiple SVG
charts (one metric a chart, stdlib only), and with `--serve PORT` serves the
directory over http.server on the loopback address by default.

Inputs found under --dir (recursively):
  stats.jsonl      JSON-line training stats (train/train_loop.py)
  model_*.pkl      checkpoints (name, size, mtime table)
  *.yaml           config files (inlined, collapsed)

Usage:
  python -m sad_tpu_torch.tools.dashboard --dir /path/to/OUTPUT_DIR \
      [--out report.html] [--serve 8080]
"""

from __future__ import annotations

import argparse
import html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from sad_tpu_torch.utils.logging import setup_logging

logger = setup_logging("dashboard")

# single-series charts: one line hue + neutral ink (text never wears the
# series color); recessive grid
_LINE = "#2563eb"
_INK = "#1f2937"
_MUTED = "#6b7280"
_GRID = "#e5e7eb"

_PRIORITY = ("loss", "lr", "time", "retnet_fg_num", "distill_normalizer")


def read_stats(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1000 or a < 0.001:
        return f"{v:.3g}"
    return f"{v:.4f}".rstrip("0").rstrip(".")


def metric_svg(
    iters: Sequence[float],
    values: Sequence[float],
    title: str,
    width: int = 320,
    height: int = 120,
) -> str:
    """One small-multiple: a single 2px polyline, min/max tick labels in
    muted ink, last value direct-labeled, recessive baseline grid."""
    pad_l, pad_r, pad_t, pad_b = 8, 64, 22, 16
    w, h = width - pad_l - pad_r, height - pad_t - pad_b
    xs = list(iters)
    ys = [float(v) for v in values]
    if not xs:
        return ""
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0

    def px(x):
        return pad_l + (x - x0) / xr * w

    def py(y):
        return pad_t + (1.0 - (y - y0) / yr) * h

    pts = " ".join(f"{px(x):.1f},{py(y):.1f}" for x, y in zip(xs, ys))
    parts = [
        f'<svg viewBox="0 0 {width} {height}" width="{width}" '
        f'height="{height}" role="img" aria-label="{html.escape(title)}">',
        f'<text x="{pad_l}" y="14" fill="{_INK}" font-size="12" '
        f'font-weight="600">{html.escape(title)}</text>',
        # recessive grid: top/bottom value lines only
        f'<line x1="{pad_l}" y1="{py(y1):.1f}" x2="{pad_l + w}" '
        f'y2="{py(y1):.1f}" stroke="{_GRID}" stroke-width="1"/>',
        f'<line x1="{pad_l}" y1="{py(y0):.1f}" x2="{pad_l + w}" '
        f'y2="{py(y0):.1f}" stroke="{_GRID}" stroke-width="1"/>',
        f'<text x="{pad_l + w + 4}" y="{py(y1) + 4:.1f}" fill="{_MUTED}" '
        f'font-size="10">{_fmt(y1)}</text>',
        f'<text x="{pad_l + w + 4}" y="{py(y0) + 4:.1f}" fill="{_MUTED}" '
        f'font-size="10">{_fmt(y0)}</text>',
        f'<polyline points="{pts}" fill="none" stroke="{_LINE}" '
        f'stroke-width="2" stroke-linejoin="round"/>',
        # direct label: the latest value (selective, not every point)
        f'<text x="{pad_l + w + 4}" y="{py(ys[-1]) - 8:.1f}" fill="{_INK}" '
        f'font-size="10" font-weight="600">{_fmt(ys[-1])}</text>',
        f'<text x="{pad_l}" y="{height - 3}" fill="{_MUTED}" '
        f'font-size="9">iter {int(x0)}..{int(x1)}</text>',
        "</svg>",
    ]
    return "".join(parts)


def _discover(root: str) -> Tuple[List[str], List[str], List[str]]:
    stats_files, ckpts, yamls = [], [], []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            if fn == "stats.jsonl":
                stats_files.append(p)
            elif fn.startswith("model_") and fn.endswith(".pkl"):
                ckpts.append(p)
            elif fn.endswith((".yaml", ".yml")):
                yamls.append(p)
    return stats_files, ckpts, yamls


def render_report(root: str) -> str:
    stats_files, ckpts, yamls = _discover(root)
    sections: List[str] = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        "<title>sad_tpu run report</title>",
        "<style>body{font-family:system-ui,sans-serif;margin:24px;"
        f"color:{_INK};background:#fff;max-width:1100px}}"
        "h1{font-size:20px}h2{font-size:15px;margin-top:28px}"
        ".charts{display:flex;flex-wrap:wrap;gap:12px}"
        ".card{border:1px solid " + _GRID + ";border-radius:6px;padding:8px}"
        "table{border-collapse:collapse;font-size:13px}"
        "td,th{padding:4px 10px;border-bottom:1px solid " + _GRID + ";"
        "text-align:left}details{margin:8px 0}"
        "pre{background:#f9fafb;padding:8px;font-size:11px;overflow:auto}"
        "</style></head><body>",
        f"<h1>sad_tpu run report — {html.escape(os.path.abspath(root))}</h1>",
    ]

    for sf in stats_files:
        rows = read_stats(sf)
        if not rows:
            continue
        rel = os.path.relpath(sf, root)
        sections.append(f"<h2>stats: {html.escape(rel)} ({len(rows)} lines)</h2>")
        iters = [r.get("iter", i) for i, r in enumerate(rows)]
        keys: List[str] = []
        numeric = set()
        for r in rows:
            for k, v in r.items():
                if k in ("iter", "eta") or k in numeric:
                    continue
                if isinstance(v, (int, float)):
                    numeric.add(k)
                    keys.append(k)
        keys.sort(key=lambda k: (_PRIORITY.index(k) if k in _PRIORITY
                                 else len(_PRIORITY), k))
        sections.append("<div class='charts'>")
        import math

        for k in keys:
            # drop non-finite values: a NaN row (the nan-abort iteration
            # logs before the finite check) would poison min/max and render
            # 'nan' SVG coordinates for the whole series
            pts = [(it, r[k]) for it, r in zip(iters, rows)
                   if isinstance(r.get(k), (int, float))
                   and math.isfinite(r[k])]
            if len(pts) < 2:
                continue
            svg = metric_svg([p[0] for p in pts], [p[1] for p in pts], k)
            sections.append(f"<div class='card'>{svg}</div>")
        sections.append("</div>")
        last = rows[-1]
        sections.append(
            "<p>last line: <code>"
            + html.escape(json.dumps(last, sort_keys=True))
            + "</code></p>"
        )

    if ckpts:
        sections.append("<h2>checkpoints</h2><table>")
        sections.append("<tr><th>file</th><th>size (MB)</th><th>mtime</th></tr>")
        import datetime

        for p in ckpts:
            st = os.stat(p)
            mt = datetime.datetime.fromtimestamp(st.st_mtime).isoformat(" ", "seconds")
            sections.append(
                f"<tr><td>{html.escape(os.path.relpath(p, root))}</td>"
                f"<td>{st.st_size / 1e6:.1f}</td><td>{mt}</td></tr>"
            )
        sections.append("</table>")

    for yp in yamls:
        try:
            with open(yp) as f:
                text = f.read()
        except OSError:
            continue
        sections.append(
            f"<details><summary>config: "
            f"{html.escape(os.path.relpath(yp, root))}</summary>"
            f"<pre>{html.escape(text)}</pre></details>"
        )

    if not stats_files and not ckpts:
        sections.append("<p>No stats.jsonl or checkpoints found under this "
                        "directory.</p>")
    sections.append("</body></html>")
    return "\n".join(sections)


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True, help="training output directory")
    ap.add_argument("--out", default=None,
                    help="report path (default <dir>/report.html)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the directory over HTTP after rendering")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --serve (default loopback; the "
                         "dir holds pickled checkpoints — expose it "
                         "deliberately, not by default)")
    args = ap.parse_args(argv)

    out = args.out or os.path.join(args.dir, "report.html")
    html_text = render_report(args.dir)
    with open(out, "w") as f:
        f.write(html_text)
    logger.info("Wrote %s (%d bytes)", out, len(html_text))

    if args.serve:
        import functools
        import http.server

        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=args.dir
        )
        logger.info("Serving %s on http://%s:%d (report.html)",
                    args.dir, args.host, args.serve)
        with http.server.ThreadingHTTPServer(
            (args.host, args.serve), handler
        ) as srv:
            srv.serve_forever()
    return out


if __name__ == "__main__":
    main()
