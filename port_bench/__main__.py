"""Run one cell once:

    python3 -m port_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of standard
output; exits non-zero, with no result, where the card or the cards the
cell asks for are missing.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402

from . import cachedirs  # noqa: E402

cachedirs.set_env()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    marks = [("torch", time.time())]
    from . import harness

    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"refused: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    marks.append(("card check", time.time()))
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels

    cuda_kernels.BUILD_DIR = cachedirs.KERNELS
    line = harness.run(cell, a.seed, a.seconds, bool(a.trace), "cuda", t0=T0, marks=marks)
    return harness.finish(line)


if __name__ == "__main__":
    sys.exit(main())
