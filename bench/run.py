"""Run one benchmark cell once on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json`` at the checkout's
root; ``bench/README.md`` says what each folder holds.
"""
import time

T_NOW = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc), so
    set-up counts the interpreter's start too; 0 where it cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main() -> int:
    t_start = T_NOW - process_age_s()
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from benchlib import cell
    return cell.main(sys.argv[1:], ROOT, t_start)


if __name__ == "__main__":
    sys.exit(main())
