"""Run cell (n) of ``chip_smoke.py``, the op library over one task's
batch of 2^23 rows, alone: its checks against the port's CPU run and
numpy, its walls, host syncs and profiles, the MIN window's peak memory
and ``_lex_searchsorted`` under the profiler, then S1's record at (n1)'s
prefix. Quicker than the whole script when only (n) changed.

    python3 tools/torch_oplib_cell.py [--seed 0]

Prints one JSON line ``{"oplib": ..., "kernels": [...]}`` and the card's
name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_oplib_cell: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spark_rapids_jni_tpu_torch import kernels

    kernels.build_all()
    rng = np.random.default_rng(args.seed)
    d = cs.make_query_data(rng, cs.FACT_ROWS, cs.ITEM_ROWS)
    od = cs.make_oplib_data(rng, d)
    res = cs.phase_oplib(kernels, d, od)
    recs = cs.oplib_kernel_records(d, od, res)
    print(json.dumps({"oplib": res, "kernels": recs}))
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
