#!/usr/bin/env python3
"""The benchmark of ``advntr_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port and ``BENCHMARK.json``.
Prints the check lines on standard error and, as the last line of
standard output, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; with ``--trace 1`` also ``breakdown``).  Exits
with another code than 0, and prints no result, without enough CUDA
devices, or when JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = ROOT / "portbench" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = harness.load_cell(args.workload, manifest)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["cell"]["chips"]:
        print("portbench: needs %d CUDA device(s); torch sees %s" % (
            spec["cell"]["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 2
    code, result = harness.execute(spec, args.seed, args.seconds,
                                   bool(args.trace))
    if result is None:
        return code or 1
    checks = result.pop("checks")
    result["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(result))
    return code


if __name__ == "__main__":
    sys.exit(main())
