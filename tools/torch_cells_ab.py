"""Time chosen cells of ``chip_smoke.py`` for several checkouts, in turns.

    python3 tools/torch_cells_ab.py --phases query,wire_plan,dispatch TREE [TREE ...]

Each TREE is a checkout of the repository (``.`` is this one). They run
in the order given, each in a process of its own, so ``old . . old``
times a parent, this tree twice and the parent again on one card. A
process builds its checkout's kernels, makes the data as that
checkout's ``chip_smoke.py`` makes it (same seed, same order, so every
checkout sees the same rows), runs the named phases of it with their
own checks (a phase the checkout does not have is skipped), and
records each profiled window (``profile_plan``): the cell's tag, its
device ms a run and its unprofiled median wall. Phases that time
themselves otherwise ((m1), (o), (p), (q), (k5), (r), (s), (t), (u),
(v), (x)) print their own lines.

Prints one line a cell and run, then one JSON line
``{"runs": [{"tree": ..., "cells": {tag: {"device_ms", "wall_ms"}}}]}``
and the card's name and power limit. Needs one CUDA device; exits 1 if
a phase failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: the data each phase of ``chip_smoke.main`` takes, by name
_PHASES = {
    "query": lambda cs, rb, k, D: cs.phase_query(rb, k, D["d"]),
    "wire_plan": lambda cs, rb, k, D: cs.phase_wire_plan(k, D["d"]),
    "dispatch": lambda cs, rb, k, D: cs.phase_dispatch(rb, k, D["d"],
                                                       D["dd"]),
    "strings": lambda cs, rb, k, D: cs.phase_strings(rb, k, D["d"],
                                                     D["sd"]),
    "decimal": lambda cs, rb, k, D: cs.phase_decimal(rb, k, D["ld"]),
    "query_step": lambda cs, rb, k, D: cs.phase_query_step(k, D["q"],
                                                           D["seed"]),
    "buckets": lambda cs, rb, k, D: cs.phase_buckets(rb, k, D["d"], D["dd"]),
    "formulations": lambda cs, rb, k, D: cs.phase_formulations(
        k, D["g"], D["d"], D["seed"]),
    "stream": lambda cs, rb, k, D: cs.phase_stream(rb, k, D["d"], {}),
    "fusion": lambda cs, rb, k, D: cs.phase_fusion(rb, D["d"], D["dd"]),
    "string_lib": lambda cs, rb, k, D: cs.phase_string_lib(rb, D["sd"],
                                                           D["seed"]),
    "io": lambda cs, rb, k, D: cs.phase_io(k, D["d"]),
    "mesh": lambda cs, rb, k, D: cs.phase_mesh(k, D["d"], D["dd"]),
    "telemetry": lambda cs, rb, k, D: cs.phase_telemetry(rb, k, D["d"], {}),
    "serving": lambda cs, rb, k, D: cs.phase_serving(rb, k, D["d"], {}),
    # (x) compares with (v)'s in-tree bytes where (v) ran first
    "native": lambda cs, rb, k, D: D.setdefault(
        "native", cs.phase_native(rb, k, D["d"])),
    "artifact": lambda cs, rb, k, D: cs.phase_artifact(rb, k, D["d"],
                                                       D.get("native")),
    "tpcds": lambda cs, rb, k, D: cs.phase_tpcds(k, D["seed"]),
}


def _child(tree: str, phases: list, seed: int) -> int:
    import numpy as np

    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    from spark_rapids_jni_tpu_torch import kernels
    from spark_rapids_jni_tpu_torch import runtime_bridge as rb

    cells = {}
    plain = cs.profile_plan

    def recorded(run, wall_ms, tag, runs=5):
        out = plain(run, wall_ms, tag, runs)
        cells[tag] = {"device_ms": out["device_ms"], "wall_ms": wall_ms}
        return out

    cs.profile_plan = recorded
    kernels.build_all()
    rng = np.random.default_rng(seed)
    # chip_smoke.main's order of draws
    D = {"d": cs.make_query_data(rng, cs.FACT_ROWS, cs.ITEM_ROWS),
         "seed": seed}
    cs.make_rowconv_wire(rng, cs.ROWCONV_ROWS)
    D["g"] = cs.make_groupby_data(rng, cs.GROUPBY_ROWS, cs.GROUPBY_KEYS)
    D["q"] = cs.make_query_step_data(rng, cs.QS_ROWS, cs.QS_ITEMS)
    D["dd"] = cs.make_dispatch_data(rng, D["d"])
    D["sd"] = cs.make_string_data(rng, D["d"])
    D["ld"] = cs.make_lineitem_data(rng, cs.DEC_ROWS)
    rc = 0
    for name in phases:
        if not hasattr(cs, "phase_" + name):
            print(f"{tree}: no phase {name}", flush=True)
            continue
        try:
            _PHASES[name](cs, rb, kernels, D)
        except Exception:  # report every phase, then fail the run
            import traceback

            traceback.print_exc()
            rc = 1
    print("CELLS " + json.dumps(cells), flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--phases", default="query,wire_plan,dispatch,decimal")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; known {sorted(_PHASES)}")
    if args.child:
        return _child(args.trees[0], phases, args.seed)
    import torch

    if not torch.cuda.is_available():
        print("torch_cells_ab: CUDA is not available", file=sys.stderr)
        return 2
    runs, rc = [], 0
    for tree in args.trees:
        tree = os.path.abspath(tree)
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--phases", args.phases, "--seed", str(args.seed), tree],
            cwd=tree, stdout=subprocess.PIPE, text=True)
        cells = {}
        for line in p.stdout.splitlines():
            if line.startswith("CELLS "):
                cells = json.loads(line[6:])
            else:
                print(line)
        rc = rc or p.returncode
        runs.append({"tree": tree, "rc": p.returncode, "cells": cells})
        for tag, c in cells.items():
            print(f"AB {os.path.basename(tree) or tree} {tag}: device "
                  f"{c['device_ms']:.3f} ms, wall {c['wall_ms']:.2f} ms",
                  flush=True)
    print(json.dumps({"runs": runs}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE,
        text=True).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
