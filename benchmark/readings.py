"""The readings that the check's limits are set from, on the card.

    python3 benchmark/readings.py --workload CELL --seeds 1,2,3 \\
        --seconds 10 [--control tf32] [--save DIR]

For each seed: one run of the cell as `run.py` makes it (untraced, with
`--seconds` of window), the numbers compared between the program and the
reference (the sound reading), and with `--control` the same numbers
between the reference computed in that precision, put in the program's
place, and the reference (the control's reading); the reference is the
configuration's own (`harness.Bench.reference`). All seeds run in one
process. With `--save`, each seed's frame outputs of the lanes compared go
to `DIR/<cell>-<seed>.npz`. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=harness.ROOT)
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        t0 = time.time()
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               args.device, root=args.root, keep=keep,
                               log=lambda m: print(m, file=sys.stderr))
        line = {"seed": seed, "sound": res["check"],
                "metrics": res["metrics"], "ref_s": keep["ref_s"],
                "steps": int(keep["prog"]["pose"].shape[1])}
        ctl = None
        if args.control:
            t1 = time.perf_counter()
            dev = torch.device(args.device)
            args_ref = (keep["reference"], keep["params"], keep["drive"],
                        keep["lanes"], line["steps"], dev)
            ctl = harness.run_reference(*args_ref, precision=args.control)
            rows = list(range(len(keep["lanes"])))
            ctl_ref = harness.run_reference(*args_ref, follow=ctl, rows=rows,
                                            checked=keep["checked"])
            line["control"] = harness.compare(ctl_ref, ctl, rows,
                                              keep["checked"],
                                              keep["limits"])
            line["control_s"] = time.perf_counter() - t1
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            sel = keep["lanes"]
            data = {f"prog_{k}": v[sel] for k, v in keep["prog"].items()}
            data.update({f"ref_{k}": v for k, v in keep["ref"].items()})
            if ctl is not None:
                data.update({f"ctl_{k}": v for k, v in ctl.items()})
                data.update({f"ctlref_{k}": v for k, v in ctl_ref.items()})
            np.savez_compressed(os.path.join(
                args.save, f"{args.workload}-{seed}.npz"),
                lanes=np.array(sel), first_step=keep["first_step"],
                checked=keep["checked"], **data)
        line["wall_s"] = time.time() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
