"""Static RD dashboard generator — parity with the reference's React
dashboard (tools/dashboard/src/components/summary.tsx): RD scatter plots
(bytes vs PSNR / SSIM) and encode-duration bars per video, rendered as a
single self-contained HTML file (inline SVG, no dependencies). A copy of
wrenc_tpu/tools/dashboard.py over the port's anchors (evaluate.ANCHORS).

    python -m wrenc_tpu_torch.tools.dashboard \
        -i results/torch/summary.json -o results/torch/dashboard.html
"""
import argparse
import json
import os
import sys

from .evaluate import ANCHORS

_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e"]


def _scale(vals, lo_px, hi_px, pad=0.05):
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    lo -= span * pad
    hi += span * pad

    def f(v):
        return lo_px + (v - lo) / (hi - lo) * (hi_px - lo_px)

    return f, lo, hi


def _svg_plot(series, xlabel, ylabel, width=460, height=320):
    """series: [(name, [(x, y), ...]), ...] -> SVG string."""
    mx, my = 60, 30
    xs = [x for _, pts in series for x, _ in pts]
    ys = [y for _, pts in series for _, y in pts]
    if not xs:
        return "<svg/>"
    fx, xlo, xhi = _scale(xs, mx, width - 15)
    fy, ylo, yhi = _scale(ys, height - my, 20)
    out = [f'<svg width="{width}" height="{height}" '
           f'xmlns="http://www.w3.org/2000/svg" '
           f'style="background:#fff;border:1px solid #ddd">']
    # axes + ticks
    out.append(f'<line x1="{mx}" y1="20" x2="{mx}" y2="{height-my}" '
               f'stroke="#999"/>')
    out.append(f'<line x1="{mx}" y1="{height-my}" x2="{width-15}" '
               f'y2="{height-my}" stroke="#999"/>')
    for i in range(5):
        xv = xlo + (xhi - xlo) * i / 4
        yv = ylo + (yhi - ylo) * i / 4
        out.append(f'<text x="{fx(xv):.0f}" y="{height-10}" '
                   f'font-size="9" text-anchor="middle">{xv:,.0f}</text>')
        out.append(f'<text x="{mx-5}" y="{fy(yv):.0f}" font-size="9" '
                   f'text-anchor="end">{yv:.2f}</text>')
    out.append(f'<text x="{(width+mx)//2}" y="{height-1}" font-size="10" '
               f'text-anchor="middle">{xlabel}</text>')
    out.append(f'<text x="12" y="{height//2}" font-size="10" '
               f'text-anchor="middle" transform="rotate(-90 12 '
               f'{height//2})">{ylabel}</text>')
    for i, (name, pts) in enumerate(series):
        c = _COLORS[i % len(_COLORS)]
        path = " ".join(f"{'M' if j == 0 else 'L'}{fx(x):.1f},{fy(y):.1f}"
                        for j, (x, y) in enumerate(sorted(pts)))
        out.append(f'<path d="{path}" fill="none" stroke="{c}" '
                   f'stroke-width="1.5"/>')
        for x, y in pts:
            out.append(f'<circle cx="{fx(x):.1f}" cy="{fy(y):.1f}" r="3" '
                       f'fill="{c}"><title>{name}: {x:,.0f} B, '
                       f'{y:.3f}</title></circle>')
        out.append(f'<rect x="{mx+8}" y="{22+i*14}" width="10" height="10" '
                   f'fill="{c}"/>')
        out.append(f'<text x="{mx+22}" y="{31+i*14}" font-size="10">'
                   f'{name}</text>')
    out.append("</svg>")
    return "".join(out)


def build_html(summary):
    parts = ["<html><head><meta charset='utf-8'>"
             "<title>wrenc-tpu results</title>"
             "<style>body{font-family:sans-serif;margin:20px}"
             "h2{margin-top:28px}</style></head><body>",
             f"<h1>wrenc-tpu evaluation — {summary.get('date', '')}</h1>"]
    bd = summary.get("bd_rate_vs_anchors", {})
    if bd:
        parts.append("<h2>BD-rate vs anchors</h2><ul>")
        for video, entries in bd.items():
            for name, ratio in entries.items():
                if ratio != ratio:  # NaN
                    continue
                d = (ratio - 1.0) * 100.0
                parts.append(f"<li>{video} vs <b>{name}</b>: "
                             f"{d:+.2f}%</li>")
        parts.append("</ul>")
    for preset in summary.get("results", []):
        for vr in preset.get("results", []):
            video = vr["video"]
            pts_psnr = [(r["bytes"], r["metrics"]["PSNR"]["summary"]["Avg"])
                        for r in vr["results"]]
            pts_ssim = [(r["bytes"], r["metrics"]["SSIM"]["summary"]["Avg"])
                        for r in vr["results"]]
            series_p = [("wrenc_tpu", pts_psnr)]
            series_s = [("wrenc_tpu", pts_ssim)]
            for name, table in ANCHORS.items():
                if video in table:
                    series_p.append(
                        (name, [(b, p) for _, b, p, _ in table[video]]))
                    series_s.append(
                        (name, [(b, s) for _, b, _, s in table[video]]))
            parts.append(f"<h2>{video}</h2>")
            parts.append(_svg_plot(series_p, "bytes", "PSNR (dB)"))
            parts.append(_svg_plot(series_s, "bytes", "SSIM"))
            durs = [(r["qp"], r["duration"]) for r in vr["results"]]
            parts.append("<h3>encode duration (s)</h3><table border=1 "
                         "cellpadding=4 style='border-collapse:collapse'>"
                         "<tr>" + "".join(f"<th>qp {q}</th>"
                                          for q, _ in durs) + "</tr><tr>"
                         + "".join(f"<td>{d:.1f}</td>" for _, d in durs)
                         + "</tr></table>")
    parts.append("</body></html>")
    return "".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(description="wrenc-tpu RD dashboard")
    ap.add_argument("-i", "--input", default="results/torch/summary.json")
    ap.add_argument("-o", "--output", default="results/torch/dashboard.html")
    args = ap.parse_args(argv)
    with open(args.input) as f:
        summary = json.load(f)
    html = build_html(summary)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        f.write(html)
    print(f"wrote {args.output} ({len(html)} bytes)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
