"""The masked-Hamming kernel against an earlier version of itself, on one
CUDA card, inside one process.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 bench_kernel.py --parent build/parent [--sweep]

``--parent`` names an unpacked checkout of an earlier commit; its
``ops/cuda_kernels.py`` (and through it its ``csrc/*.cu``) is loaded beside
the working tree's. Both kernels are built, checked bit-exact against each
other, and timed at the main path's shapes (``chip_smoke.kernel_cases``) in
the order parent, tree, tree, parent:

  kernel_ms  device time per call: 20 calls captured in a CUDA graph, the
             replay timed between two events;
  call_ms    events around one call on an idle card, the wrapper included.

A parent whose wrapper takes one problem at a time gets a batched shape as
B calls (as its main path made them), so a "call" is one sweep set for
both. ``--sweep`` also times the tree's kernel at fixed queries-per-block
against the wrapper's own choice. Without ``--parent`` only the tree is
timed. Prints one line per measurement with the card's name and power
limit, and writes ``chiprun_out/bench_kernel.json``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

sys.modules["jax"] = None  # the port must never need JAX
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

OUT = "chiprun_out/bench_kernel.json"


def load_parent(root):
    path = os.path.join(root, "orbslam2_with_quadrics_tpu_torch", "ops", "cuda_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_cuda_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_problem(fn):
    """``fn`` of one problem lifted to a batch: one call per entry."""
    def call(*args):
        if args[2].dim() == 1:
            return fn(*args)
        shared = args[7].dim() == 1
        outs = [fn(*[t[b] for t in args[:5]], *(args[5:] if shared else [t[b] for t in args[5:]]))
                for b in range(args[2].shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    return call


def takes_batches(fn) -> bool:
    try:
        fn(*chip_smoke.hamming_case(8, 8, 0, B=2))
    except ValueError:
        return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="unpacked checkout of the commit to compare with")
    ap.add_argument("--sweep", action="store_true", help="time fixed queries-per-block too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernel: CUDA is not available; this run needs one CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__}; {smi}", flush=True)

    versions = {"tree": ck.masked_hamming_best2}
    order = ["tree", "tree"]
    if args.parent:
        fn = load_parent(args.parent).masked_hamming_best2
        versions["parent"] = fn if takes_batches(fn) else per_problem(fn)
        order = ["parent", "tree", "tree", "parent"]
    rows = []
    for name, case, timed in chip_smoke.kernel_cases():
        if "parent" in versions:
            err = chip_smoke.max_abs_diff(versions["parent"](*case), versions["tree"](*case))
            if err != 0:
                raise AssertionError(f"parent and tree disagree on {name} (max diff {err})")
        if not timed:
            continue
        for slot, v in enumerate(order):
            row = {"shape": name, "slot": slot, "version": v,
                   "kernel_ms": chip_smoke.graph_kernel_ms(lambda: versions[v](*case)),
                   "call_ms": chip_smoke.cuda_median_ms(lambda: versions[v](*case))}
            rows.append(row)
            print(f"[ab] {name} {v}: kernel_ms {row['kernel_ms']:.5f}, call_ms "
                  f"{row['call_ms']:.5f} ({smi})", flush=True)
        if args.sweep:
            for qpb in (None, 8, 16, 24, 32, 40, 48, 64):
                k = chip_smoke.graph_kernel_ms(
                    lambda: ck.masked_hamming_best2(*case, q_per_block=qpb))
                rows.append({"shape": name, "version": "tree", "q_per_block": qpb,
                             "kernel_ms": k})
                print(f"[sweep] {name} q_per_block={qpb}: kernel_ms {k:.5f} ({smi})",
                      flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
