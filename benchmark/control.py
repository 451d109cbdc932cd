"""The control of a cell's correctness check: the plain reference, computed
in the precision below the configuration's (bfloat16 for float32), put in
the program's place and compared as a run compares the program.  It has to
come out not correct.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
        [--passes <n>]

prints one JSON line a seed and variant: the control, then each fault the
cell can have, planted in the float32 reference put in the program's place
(a step that leaves its state unchanged, half the batch left out with the
mean taken over the rest, every answer altered by 0.1%), with the compared
numbers beside their limits and whether they pass.  ``--passes`` is the render kind's window in passes (a
run's count); the grad kind follows the reference's steps.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core  # noqa: E402


def control(root: str, workload: str, seed: int, passes: int,
            device: str = "cuda") -> list:
    """One record a variant (the control and each fault the cell's kind
    plants) for ``seed``."""
    import torch
    found = core.find_cell(core.load_spec(root), root, workload)
    kind = core.load_kind(found["traffic"]["kind"])
    args = dict(seed=seed, device=device, dtype=torch.bfloat16,
                passes=passes)
    return [{"workload": workload, "seed": seed, "variant": v,
             "correct": kind.passed(checks), "checks": checks}
            for v, checks in kind.control(found, **args).items()]


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--passes", type=int, default=40)
    args = p.parse_args(argv)
    root = os.getcwd()
    core.set_caches(root)
    cell = {w["name"]: w for w in core.load_spec(root)["workloads"]}[
        args.workload]
    try:
        core.require_cards(int(cell["chips"]))
    except core.NoCard as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for record in control(root, args.workload, seed, args.passes):
            print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
