"""``ba_system_ms``: the mean device time per LM step of the port's
``ba.system`` span: ``_build_system`` (the edge terms, the Hcc, Hpp, W
blocks and their segment sums) and ``_schur_rhs`` (the step's right-hand
side). :func:`per_step_ms` is shared by the readers of the step's phases."""

from __future__ import annotations

from .gba_build_ms import window_spans


def per_step_ms(ctx, name: str):
    """Device ms of the spans named ``name`` over the window, per LM step
    (``ba.step`` span), or None where the port has no spans."""
    spans = window_spans(ctx)
    if spans is None:
        return None
    steps = sum(s["name"] == "ba.step" for s in spans)
    return sum(s["device_ms"] for s in spans if s["name"] == name) / steps


def read(ctx):
    return per_step_ms(ctx, "ba.system")
