"""``setup_s``: from the start of the process to the end of the warm call:
imports, the card, the inputs, the port's state and the warm call."""

from __future__ import annotations


def read(ctx):
    return ctx.setup_s
