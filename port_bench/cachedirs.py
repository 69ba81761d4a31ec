"""The fixed cache directories of a run, inside the checkout.

``set_env`` points PyTorch's extension builds, Triton's kernel cache,
CUDA's JIT cache and Python's bytecode cache at ``port_bench/.cache/``;
call it before ``torch`` is imported. The bytecode is written there even
where the environment asks Python to write none (``PYTHONDONTWRITEBYTECODE``,
which leaves every run to compile torch's two thousand modules anew: some
five seconds of set-up, and the part that varies most). ``KERNELS`` is
where the port's own ``nvcc`` builds go (``cuda_kernels.BUILD_DIR``), set
once the port is imported.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent / ".cache"
KERNELS = ROOT / "torch_kernels"


def set_env():
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(ROOT / sub)
    os.environ["USE_FLAX"] = "0"
    sys.pycache_prefix = str(ROOT / "pycache")
    sys.dont_write_bytecode = False
