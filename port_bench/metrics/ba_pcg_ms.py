"""``ba_pcg_ms``: the mean device time per LM step of the port's ``ba.pcg``
span: the block-Jacobi preconditioner's inverse and the PCG's iterations,
each two edge sweeps (``_schur_matvec``)."""

from __future__ import annotations

from .ba_system_ms import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "ba.pcg")
