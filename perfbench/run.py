"""One run of one benchmark cell of the PyTorch/CUDA port:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (harness/main.py says what it prints). The
set-up time counts from the start of this file. Caches of anything that
compiles stay inside the checkout, at fixed paths.
"""

import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)
sys.path[:0] = [HERE, ROOT]

if __name__ == "__main__":
    from harness.main import main

    sys.exit(main(sys.argv[1:], T0))
