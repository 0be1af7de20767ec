"""The correctness check's control and its readings, in one process.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \\
        [--program-seeds 4,5,6] [--calls 2]

For each seed: the cell's set-up, ``--calls`` calls of the timed path at
the cell's own size, then ``run.verify`` over them for the program (the
sound readings that set each limit's lower end) and, on ``--seeds`` but
not ``--program-seeds``, again with the control in the program's place
(the reference computed in bfloat16, the precision below the
configuration's float32, stage by stage from the same inputs), which must
come out not correct. Prints one
JSON line per seed and a last line with each number's largest program
reading and smallest control reading. Not run by the benchmark's runs.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell_name, seeds, calls, device="cuda", overrides=None,
             out=sys.stdout, program_seeds=()):
    sys.path.insert(0, str(ROOT))
    from port_bench import check, run

    lows, highs = {}, {}
    limits = check.load_limits(cell_name)
    for seed in list(seeds) + list(program_seeds):
        with tempfile.TemporaryDirectory() as workdir:
            cell = run.Cell(cell_name, seed, device, overrides, workdir)
            outs = [cell.call(i) for i in range(calls)]
            picks = list(range(calls))
            prog = run.verify(cell, outs, picks)
            ctrl = (run.verify(cell, outs, picks, control=True)
                    if seed in seeds else {})
        line = dict(seed=seed, program=prog, control=ctrl,
                    program_correct=check.judge(prog, limits)[0])
        if ctrl:
            line["control_correct"] = check.judge(ctrl, limits)[0]
        print(json.dumps(line), file=out, flush=True)
        for k, v in prog.items():
            lows[k] = max(lows.get(k, v), v)
        for k, v in ctrl.items():
            highs[k] = min(highs.get(k, v), v)
    summary = dict(workload=cell_name, seeds=list(seeds),
                   program_seeds=list(program_seeds), program_max=lows,
                   control_min=highs)
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--calls", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import run

    run.cuda_ready(1)
    readings(args.workload, [int(s) for s in args.seeds.split(",")],
             args.calls, program_seeds=[int(s) for s in
                                        args.program_seeds.split(",") if s])
    return 0


if __name__ == "__main__":
    sys.exit(main())
