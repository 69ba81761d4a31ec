"""``gba_build_ms``: the global BA's problem build, the mean device time of
the port's ``gba.build`` span (``run_global_ba``'s ``_valid_obs``,
``_edge_table`` and the ``BAProblem``) over the window's solves.

The port's own tracer (``orbslam2_with_quadrics_tpu_torch/utils/tracing.py``)
records spans while the profiler of a ``--trace 1`` window records; the
warm call runs before it, so its store holds the window's solves alone.
:func:`window_spans` is what every reader of those spans starts from.
"""

from __future__ import annotations


def window_spans(ctx):
    """The port's spans of the window that the card timed, or None where
    there are none (a program without the tracer, a run off the card).
    Raises where their ``gba.solve`` spans are not the window's solves."""
    try:
        from orbslam2_with_quadrics_tpu_torch.utils import tracing
    except ImportError:             # a program without the tracer
        return None
    spans = [s for s in tracing.spans() if s["device_ms"] is not None]
    if not spans:
        return None
    n = sum(s["name"] == "gba.solve" for s in spans)
    if n != ctx.calls:
        raise RuntimeError(f"the port's spans hold {n} gba.solve spans; the window ran "
                           f"{ctx.calls} solves")
    return spans


def _cover(spans, root):
    """Share of ``root``'s device time that its build, purge and solves
    (LM steps and initial cost) account for."""
    under = [s for s in spans if s["parent"] == root["id"]]
    return sum(s["device_ms"] for s in under
               if s["name"] in ("gba.build", "ba.purge", "ba.solve")) / root["device_ms"]


def read(ctx):
    spans = window_spans(ctx)
    if spans is None:
        return None
    builds = [s["device_ms"] for s in spans if s["name"] == "gba.build"]
    roots = [s for s in spans if s["name"] == "gba.solve"]
    covers = ", ".join(f"{100 * _cover(spans, r):.3f}%" for r in roots)
    ctx.notes.append(f"gba_build_ms: gba.solve {', '.join(str(r['device_ms']) for r in roots)} "
                     f"device ms; build, purge and solves cover {covers} of it; "
                     f"window_s / calls {ctx.window_s / ctx.calls:.6f} s")
    return sum(builds) / len(roots)
