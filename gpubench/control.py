"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the next precision below the configured one
(bfloat16 for float32: the models do no matrix products, so TF32 does not
apply), compared with the reference in the configured precision by the
comparison that decides ``correct``. A sound comparison finds the control
not correct.

The same script reads the comparison's sound witnesses, which a sound
comparison finds correct: ``--kind rounded-twice`` (the reference in the
configured precision with every fused multiply-add rounded twice: a
correct program that contracts or orders its arithmetic otherwise) and
``--kind float64`` (the reference in float64).

    python3 gpubench/control.py --workload <cell> --seeds <n> [<n> ...] [--kind <kind>]

Each seed makes the inputs of the run's first call and checks as many of
its members as a run checks, at the cell's own size; one line per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LOWER = {"float64": "float32", "float32": "bfloat16"}
KINDS = ("control", "rounded-twice", "float64")


def control_gap(name: str, seed: int, device: str, root: Path = ROOT, kind: str = "control"):
    """``(gap, limit, seconds)`` of the control (or of the witness ``kind``)
    on the inputs of seed ``seed``'s first call."""
    import torch

    from gpubench.run import load_cell
    from gpubench.traffic import workload

    spec = load_cell(name, root)
    cfg = spec["config"]
    wl = workload(cfg, spec["traffic"], seed, device, root)
    t0 = time.perf_counter()
    dtype = {"control": LOWER[cfg["dtype"]], "rounded-twice": cfg["dtype"],
             "float64": "float64"}[kind]
    gap = wl.control(getattr(torch, dtype), fused=kind != "rounded-twice")
    return gap, float(spec["limits"][wl.CHECK]), time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kind", choices=KINDS, default="control")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        gap, limit, secs = control_gap(args.workload, seed, args.device, kind=args.kind)
        print(json.dumps({"workload": args.workload, "kind": args.kind, "seed": seed,
                          "gap": gap, "limit": limit, "fails": not gap <= limit,
                          "seconds": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
