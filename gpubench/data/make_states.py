"""Make the MIZ states that traffic files start from, computed once by the
benchmark's plain reference on the CPU in float32 at ``SpaceTime{sin}(180,
2000)`` from zero initial conditions with the default MIZ parameters:

- ``miz-attractors.json``: the two states that the transitions traffic
  runs between, 40 model years under a constant forcing of +15 W/m^2 (the
  ice-free state ``a``) and of -25 W/m^2 (the ice-covered state ``b``);
- ``miz-spinup.json``: the state the sweep traffic starts each call from,
  the end of EnergyBalanceModel.jl's test run (``test/runtests.jl:22-32``),
  30 model years with no forcing.

    python3 gpubench/data/make_states.py

The program and the reference start from the committed files, so a run's
set-up does not rerun the years."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

from gpubench.reference import run_state  # noqa: E402
from gpubench.reference.common import Grid  # noqa: E402

# file -> (model years, state name -> constant forcing in W/m^2)
FILES = {"miz-attractors.json": (40, {"a": 15.0, "b": -25.0}),
         "miz-spinup.json": (30, {"spunup": 0.0})}
FIELDS = ("Ei", "Ew", "h", "D", "phi")


def main() -> int:
    config = json.loads((HERE.parent / "configs" / "miz-default.json").read_text())
    grid = Grid(180, 2000)
    torch.set_num_threads(1)
    for name, (years, forcings) in FILES.items():
        par = dict(config["parameters"], F=np.array(list(forcings.values())))
        init = {k: np.zeros((len(forcings), grid.nx)) for k in FIELDS}
        state = run_state("MIZ", grid, par, init, years, torch.float32, "cpu",
                          config["newton"], 0.0).state
        out = {"about": f"made by make_states.py: {years} years from zero at (180, 2000)",
               "grid": [grid.nx, grid.nt], "years": years, "forcing": forcings,
               "dtype": "float32",
               "states": {s: {k: [float(v) for v in state[k][j]] for k in FIELDS}
                          for j, s in enumerate(forcings)}}
        (HERE / name).write_text(json.dumps(out, indent=0) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
