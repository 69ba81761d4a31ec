"""The readings that a cell's limits are set from, for many seeds in one process.

    python3 -m port_bench.readings --workload <name> --seeds 1 2 3 [--also tf32 float32] [--out FILE]

For each seed: the inputs, the port's call through the window's own
entry (twice: the warm call and a second), the reference, and the numbers
of the entry's ``judge`` for each of the port's answers (``port``,
``port2``). ``--also`` puts the reference in another of the entry's
precisions (``PRECISIONS``) in the port's place and judges it the same
way: ``tf32`` is the control (float32 with its matrix products' operands
rounded to TF32), ``float32`` the reference in the port's own precision.
One JSON line a seed, on standard output and appended to ``--out``.
"""

if __name__ == "__main__":
    from port_bench import cachedirs

    cachedirs.set_env()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from . import harness  # noqa: E402


def read_seed(cell, seed: int, device="cuda", also=()) -> dict:
    """One seed's row: the inputs' counts, the port's two calls and each
    precision of ``also``, each judged against the reference."""
    entry = importlib.import_module(f"{__package__}.entries.{cell.mix['entry']}")
    dev = torch.device(device)
    row = {"workload": cell.name, "seed": seed,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type}

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    with torch.no_grad():
        inp = entry.inputs(cell.cfg, cell.mix, seed, dev)
        row["inputs"] = entry.counts(inp)
        call = entry.prepare(inp, cell.cfg, cell.mix, dev)
        answers = {}
        for tag in ("port", "port2"):
            (out, record), row[f"{tag}_s"] = timed(call)
            answers[tag] = ({k: v.clone() for k, v in out.items()}, record)
        del call, out
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref, row["reference_s"] = timed(lambda: entry.reference(inp, cell.cfg, cell.mix))
        row["reference_cost"], row["purged"] = float(ref["cost"]), ref["purged"]
        for precision in also:
            ans, row[f"{precision}_s"] = timed(lambda: entry.reference(inp, cell.cfg, cell.mix, precision))
            answers[precision] = (ans, ans["cost"])
        for tag, (ans, record) in answers.items():
            row[tag], row[f"{tag}_failed"] = entry.judge(ans, [record], ref, inp, cell.limits)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--also", nargs="*", default=[])
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    for seed in a.seeds:
        line = json.dumps(read_seed(cell, seed, "cuda", a.also))
        torch.cuda.empty_cache()
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
