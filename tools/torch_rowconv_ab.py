"""Time cell (b) of ``chip_smoke.py``, the row conversion plan
``[to_rows, from_rows]`` over 4,194,304 rows of the RowConversionTest
schema, for two or more checkouts of the PyTorch port in turns.

    python3 tools/torch_rowconv_ab.py ROOT_A ROOT_B [--pairs 5] [--runs 50]

Each ROOT is a directory that holds a ``spark_rapids_jni_tpu_torch``
package. The turns run A, B, B, A for each pair (with more roots, the
list and its reverse), every turn in a process of its own (each builds
its kernels under its ROOT's ``build/``). A turn uploads (b)'s batch to the card, checks one round trip byte for byte,
and prints one JSON line:

* ``median_ms``, ``q1_ms``, ``q3_ms``: the plan's wall over ``--runs``
  runs after 5 warm ones, host clock around ``table_plan_resident`` and
  ``torch.cuda.synchronize()``, as (b) times it;
* ``host_us``: the fastest of 5 rounds of 200 calls of the same plan over
  a 64-row table, the host's cost of one resident plan when the card has
  next to nothing to do.

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def turn(root: str, runs: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from spark_rapids_jni_tpu_torch import runtime_bridge as rb

    pkg = os.path.dirname(os.path.abspath(rb.__file__))
    if not pkg.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported the port from {pkg}, not {root}")
    cs = _chip_smoke()
    plan = json.dumps([
        {"op": "to_rows"},
        {"op": "from_rows", "type_ids": cs.ROWCONV_TYPES,
         "scales": cs.ROWCONV_SCALES},
    ])
    rng = np.random.default_rng(0)
    wire = cs.make_rowconv_wire(rng, cs.ROWCONV_ROWS)
    tid = rb.table_upload_wire(*wire, device="cuda")
    out = rb.table_plan_resident(plan, [tid])
    if tuple(rb.table_download_wire(out)) != tuple(wire):
        raise AssertionError("(b)'s round trip changed the bytes")
    rb.table_free(out)
    for _ in range(5):
        rb.table_free(rb.table_plan_resident(plan, [tid]))
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = rb.table_plan_resident(plan, [tid])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rb.table_free(out)
    rb.table_free(tid)
    small = rb.table_upload_wire(*cs.make_rowconv_wire(rng, 64),
                                 device="cuda")
    for _ in range(20):
        rb.table_free(rb.table_plan_resident(plan, [small]))
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(200):
            rb.table_free(rb.table_plan_resident(plan, [small]))
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / 200 * 1e6)
    rb.table_free(small)
    q = statistics.quantiles(times, n=4)
    return {"root": root, "median_ms": statistics.median(times),
            "q1_ms": q[0], "q3_ms": q[2], "host_us": min(rounds),
            "host_us_all": rounds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--runs", type=int, default=50)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        print(json.dumps(turn(args.turn, args.runs)), flush=True)
        return 0
    rc = 0
    for _ in range(args.pairs):
        for root in args.roots + args.roots[::-1]:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--turn", root,
                 "--runs", str(args.runs), root],
                capture_output=True, text=True, timeout=600)
            lines = p.stdout.strip().splitlines()
            if p.returncode or not lines:
                sys.stderr.write(p.stderr[-4000:])
                print(json.dumps({"root": root, "rc": p.returncode}))
                rc = 1
            else:
                print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
