"""Run one cell of the benchmark once and print its result as the last
line of standard output (``benchmark/README.md``):

    python3 benchmark/run.py --workload c5_step --seed 7 --seconds 10 --trace 0

It runs on the machine it is started on, needs as many CUDA cards as the
cell asks for, and exits with a code other than 0, printing no result,
where there are fewer or where the program under test cannot be imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, few threads: the window's work is on the card, and idle
# worker threads that spin take cores from the host thread that drives it
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    cell = harness.Bench(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import tpurt_torch

    where = Path(tpurt_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"the program under test is imported from {where}, outside this checkout",
              file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
