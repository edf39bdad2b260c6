"""Run one cell of the benchmark (``BENCHMARK.json``) on this machine's
card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result's JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error.  The program under test is ``src/repro_torch``; its kernels build
into its own ``kernels/_build`` inside this checkout, and other caches go
under ``.perfbench_cache`` here.  The process runs with one thread per
math library.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: the host's side of serving is one Python
# thread launching work, and idle pool threads only contend with it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from perfbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
