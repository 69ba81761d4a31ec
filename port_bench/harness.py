"""One run of one cell: set-up, the measured window, the check, the result line.

A cell (``workloads`` in ``BENCHMARK.json``) ties together files found by
name: the configuration's file (``configs/<config>.json``), the traffic mix
(``traffic/<mix>.json``: the entry the window drives and its schedule), the
entry (``entries/<entry>.py``), the limits of the comparison
(``limits/<workload>.json``) and one reader per metric
(``metrics/<metric>.py``, end-to-end and per-layer alike). Adding a
configuration, a mix, an entry or a metric adds files and entries; it
edits none of these.

An entry is a module with these functions, which the harness calls in
this order:

- ``inputs(cfg, mix, seed, device)``: the inputs both sides are handed,
  made on the device from the seed;
- ``counts(inputs)``: what they hold, a dict of whole numbers (logged,
  and read by the metric readers);
- ``prepare(inputs, cfg, mix, device)``: a zero-argument callable, one call
  of the port, which returns ``(answer, record)``: the answer a dict of
  tensors, the record what the check keeps of every call;
- ``reference(inputs, cfg, mix)``: the plain reference's answer;
- ``judge(answer, records, ref, inputs, limits)``: ``(numbers, failed)``,
  the numbers that the limits name, from the last call's answer and every
  call's record, and the calls whose own record fails its limit;

and ``steps_per_call(mix)`` where a reader asks for it.

A run:

1. set-up (``setup_s``, from the start of the process): the inputs made on
   the device from the seed, the port's state laid out from them, and one
   warm call;
2. the window: calls back to back, each followed by
   ``torch.cuda.synchronize()``, until the first that ends ``--seconds``
   after the start (``--trace 1``: the mix's ``trace_seconds``, under
   ``torch.profiler``);
3. the check, once the window has closed and the peak memory is read:
   the port's state freed, the reference worked out from the same inputs,
   the answers judged (``checks.py``);
4. the line: one JSON object, the last line of standard output, with each
   number compared beside its limit under ``checks``, which also closes
   standard error. With ``--trace 0`` its metrics are the cell's
   end-to-end metrics, with ``--trace 1`` its per-layer metrics: each read
   by its reader from what the run saw (``Run`` below); a reader that
   finds nothing to read returns None, and the metric is left out.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import checks, trace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam2_with_quadrics_tpu")


def load_cell(name: str, root: Path = HERE.parent) -> SimpleNamespace:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    data = root / HERE.name
    mix = json.loads((data / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(m):
        return name in m.get("workloads", [name])

    return SimpleNamespace(
        name=name, chips=int(cell["chips"]), cfg=cfg, mix=mix,
        limits=json.loads((data / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run(SimpleNamespace):
    """What a metric's reader reads: ``setup_s``; ``calls`` and
    ``window_s``, the window's whole calls and its length; ``call_s``, each
    call's seconds; ``trace``, the traced window's summary
    (``trace.Summary``) or None; ``counts``, the entry's counts of the
    inputs; ``cfg``, ``mix`` and ``entry``; ``peak``, the device's
    published peaks (``peaks.json``) or None; ``notes``, lines a reader
    adds to standard error."""


def run(cell: SimpleNamespace, seed: int, seconds: float, traced: bool, device="cuda",
        t0: float | None = None, marks=(), log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """One run; returns the result line's object (``correct`` and all).
    ``marks``: (label, time) of the steps of set-up before this call."""
    t0 = time.time() if t0 is None else t0
    dev = torch.device(device)
    entry = importlib.import_module(f"{__package__}.entries.{cell.mix['entry']}")
    marks = list(marks) + [("imports", time.time())]
    with torch.no_grad():
        inp = entry.inputs(cell.cfg, cell.mix, seed, dev)
        counts = entry.counts(inp)
        marks.append(("inputs", time.time()))
        call = entry.prepare(inp, cell.cfg, cell.mix, dev)
        marks.append(("state", time.time()))
        answer, _ = call()                              # the warm call
        _sync(dev)
        marks.append(("warm call", time.time()))
        setup_s = marks[-1][1] - t0
        log(f"inputs: {json.dumps(counts)}")
        log("setup: " + ", ".join(f"{label} {b - a:.3f} s" for (label, b), a in
                                  zip(marks, [t0] + [t for _, t in marks[:-1]])))
        window = min(seconds, float(cell.mix["trace_seconds"])) if traced else seconds
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced else None
        records, ends = [], []
        with prof if traced else contextlib.nullcontext():
            start = time.perf_counter()
            while True:
                with record_function(trace.SPAN_PREFIX + "solve"):
                    answer, record = call()
                with record_function(trace.SPAN_PREFIX + "sync"):
                    _sync(dev)
                ends.append(time.perf_counter())
                records.append(record)
                if ends[-1] - start >= window:
                    break
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        last = {k: v.clone() for k, v in answer.items()}
        del call, answer
        gc.collect()
        summary = trace.summarize(prof) if prof is not None else None
        del prof
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        # the check
        t_ref = time.perf_counter()
        ref = entry.reference(inp, cell.cfg, cell.mix)
        nums, failed = entry.judge(last, records, ref, inp, cell.limits)
        ref_s = time.perf_counter() - t_ref
    checked, ok = checks.judge(nums, cell.limits)
    n = len(ends)
    log(f"window: {n} calls in {ends[-1] - start:.6f} s; reference and check {ref_s:.3f} s")

    ctx = Run(setup_s=setup_s, calls=n, window_s=ends[-1] - start,
              call_s=[b - a for a, b in zip([start] + ends[:-1], ends)], trace=summary,
              counts=counts, cfg=cell.cfg, mix=cell.mix, entry=entry, peak=_device_peaks(dev),
              notes=[])
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        v = importlib.import_module(f"{__package__}.metrics.{m['name']}").read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device_info["power_limit_w"] = _power_limit_w()
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    line = {"correct": bool(ok), "attempted": n, "failed": int(failed),
            "metrics": metrics, "device": device_info}
    if summary is not None:
        line["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    line["checks"] = checked
    for note in ctx.notes:
        log(note)
    return line


def _device_peaks(dev):
    """The published peaks of this device (``peaks.json``), or None."""
    if dev.type != "cuda":
        return None
    return json.loads((HERE / "peaks.json").read_text()).get(torch.cuda.get_device_name(dev))


def finish(line: dict, log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> int:
    """Print the result; the numbers compared, each beside its limit, are
    the last lines of standard error. Refuses (no line, code 3) where the
    process has loaded JAX or the JAX package."""
    bad = loaded_forbidden()
    if bad:
        log(f"refused: the process has loaded {', '.join(bad)}")
        return 3
    print(json.dumps(line), flush=True)
    for k, c in line["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return 0
