"""``python3 -m navbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (see ``navbench/run.py``)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from navbench.run import main

    sys.exit(main(t_start=T_START))
