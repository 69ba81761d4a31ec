"""``ba_solve_ms``: the window's wall time over the whole calls (solves) it
completed, each call followed by ``torch.cuda.synchronize()``."""

from __future__ import annotations


def read(ctx):
    return 1e3 * ctx.window_s / ctx.calls
