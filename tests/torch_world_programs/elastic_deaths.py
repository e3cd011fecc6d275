"""A scripted sequence of rank deaths for the elastic launchers
(standard library only, so both packages' launchers run it as it is).

    launch -n N --elastic [--elastic-policy P] elastic_deaths.py OUT S0,S1,...

In generation g the rank whose launcher slot is ``S<g>`` exits with code 17;
every other rank waits for the launcher's ``gen_<g+1>.json`` in
``MPI4JAX_TPU_ELASTIC_DIR``, copies it into ``OUT`` and goes on to the next
generation.  After the last death every rank exits 0.  A rank respawned
into generation g starts there (``MPI4JAX_TPU_GENERATION``), so the slot
of a death must not die again in a later generation.
"""

import json
import os
import shutil
import sys
import time


def main():
    out, deaths = sys.argv[1], [int(s) for s in sys.argv[2].split(",")]
    slot = int(os.environ.get("MPI4JAX_TPU_SLOT",
                              os.environ["MPI4JAX_TPU_RANK"]))
    gen = int(os.environ.get("MPI4JAX_TPU_GENERATION", "0"))
    gen_dir = os.environ["MPI4JAX_TPU_ELASTIC_DIR"]
    deadline = time.monotonic() + 60
    while gen < len(deaths):
        if deaths[gen] == slot:
            sys.exit(17)
        path = os.path.join(gen_dir, f"gen_{gen + 1}.json")
        while True:
            try:
                with open(path) as f:
                    json.load(f)
                break
            except (OSError, ValueError):
                if time.monotonic() > deadline:
                    sys.exit(f"slot {slot}: no {path}")
                time.sleep(0.02)
        tmp = os.path.join(out, f".gen_{gen + 1}.{slot}")
        shutil.copyfile(path, tmp)
        os.replace(tmp, os.path.join(out, f"gen_{gen + 1}.json"))
        gen += 1


if __name__ == "__main__":
    main()
