"""``ba_update_ms``: the mean device time per LM step of the port's
``ba.update`` span: the points' back-substitution, the retraction, the
candidate's cost and the accept."""

from __future__ import annotations

from .ba_system_ms import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ba.update")
