#!/usr/bin/env python3
"""The control of ``correct``: the plain reference put in the program's
place, computed one precision below the program's float32 (bfloat16), on a
cell's own inputs and as many checked loci as a run compares.  Each seed
prints the numbers the check compares; the control has to fail one of
them.  The benchmark's own runs do not run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--dtype bfloat16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(spec: dict, seed: int, dtype, device: str) -> dict:
    """The check's numbers for the reference in ``dtype`` against the
    reference in float64, over the loci a run of ``seed`` would check."""
    import torch
    from portbench import generate
    from portbench.reference import check
    cfg, tr = spec["config"], spec["traffic"]
    loci = generate.make_panel(cfg)
    vids = [lc.vid for lc in loci][:tr["loci_per_call"]]
    rng = random.Random(seed * 7919 + 17)
    scale = cfg["panel"]["loci"] / cfg["published"]["loci"]
    rows = []
    for s in range(tr["samples"]):
        reads, _, placed = generate.make_sample(loci, tr, seed, s, scale)
        ref = check.Reference(cfg, loci, reads, device, placed=placed)
        low = check.Reference(cfg, loci, reads, device, dtype, placed)
        low._recruited = ref.recruited()
        for vid in rng.sample(vids, min(tr["check_loci"], len(vids))):
            if cfg["platform"] == "illumina":
                r, p = ref.short_locus(vid), low.short_locus(vid)
            else:
                r, p = ref.long_locus(vid), low.long_locus(vid)
            rows.append(check.compare(cfg["platform"], p, r))
        del ref, low
        if device == "cuda":
            torch.cuda.empty_cache()
    out = check.combine(rows)
    out["loci_checked"] = len(rows)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = harness.load_cell(args.workload, manifest)
    dtype = getattr(torch, args.dtype)
    limits = spec["workload"]["limits"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        n = control_numbers(spec, seed, dtype, args.device)
        fails = [k for k, lim in limits.items() if n[k] > lim]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "numbers": n,
                          "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
