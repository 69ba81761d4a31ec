"""``ba_live_row_pct``: the share of the rows the solver sweeps that carry a
live edge, 100 x the sum of ``live_rows`` over the sum of ``rows`` of the
window's ``ba.step`` spans (each LM step sweeps every row of the edge
table; the purge lowers the live ones). Notes the first step of each
solve beside the inputs' live edges and rows, which it should count."""

from __future__ import annotations

from .gba_build_ms import window_spans


def read(ctx):
    spans = window_spans(ctx)
    if spans is None:
        return None
    steps = [s for s in spans if s["name"] == "ba.step"]
    first = {}                                   # each ba.solve's first step
    for s in sorted(steps, key=lambda s: s["id"]):
        first.setdefault(s["parent"], s["counts"])
    ctx.notes.append(f"ba_live_row_pct: inputs {ctx.counts['edges']} edges of {ctx.counts['rows']} "
                     f"rows; each solve's first step (live_rows, rows) "
                     f"{[(c['live_rows'], c['rows']) for _, c in sorted(first.items())]}")
    counts = [s["counts"] for s in steps]
    return 100.0 * sum(c["live_rows"] for c in counts) / sum(c["rows"] for c in counts)
