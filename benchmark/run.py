"""Run one benchmark cell once (see ``harness/cli.py``):

    python3 benchmark/run.py --workload pose2vid-512.f16 --seed 7 --seconds 40 --trace 0
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent)]
    from harness.cli import main

    sys.exit(main(t_start=T_START))
