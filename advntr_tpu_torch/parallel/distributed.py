"""Scale-out over processes: locus-sharded panels, one process a shard.

Counterpart of advntr_tpu/parallel/distributed.py.  The layout is the
reference's:

- each process owns a contiguous shard of the locus panel (its model
  DB slice lives in host RAM, compiled models on its device)
- each process streams its own copy of the alignment's unmapped reads
  through the recruitment filter for its loci
- per-locus genotyping is embarrassingly parallel; the only traffic
  between processes is the final ordered gather of small genotype
  records to process 0, through the filesystem

No collective is used, so nothing on the main path calls ``initialize``;
processes that share one card need no process group at all.
"""

from __future__ import annotations

import json
import os
import time

import torch


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str = "cuda") -> None:
    """Bring up a torch.distributed process group (no-op when
    single-process): gloo for ``cpu``, nccl for ``cuda``, at
    ``tcp://{coordinator_address}``.  Counterpart of
    ``jax.distributed.initialize``; nccl refuses two ranks on one card."""
    import torch.distributed as dist
    if num_processes is None or num_processes <= 1:
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shard_loci(target_vntr_ids, process_id: int, num_processes: int):
    """Contiguous locus shard for this host."""
    n = len(target_vntr_ids)
    per = (n + num_processes - 1) // num_processes
    return target_vntr_ids[process_id * per:(process_id + 1) * per]


def gather_results(local_results: dict, process_id: int,
                   num_processes: int, output_dir: str,
                   timeout_s: float = 600.0):
    """Ordered cross-host merge of per-locus genotype records.

    Genotype records are tiny (a few bytes per locus), so the merge is a
    filesystem gather: each host atomically publishes its shard (write to a
    temp name + rename), host 0 waits for every shard and merges in panel
    order.  A shard that never appears within ``timeout_s`` is a hard error
    — a silently incomplete panel must never look like a complete one.  On
    pod slices with a shared filesystem this needs no network code; swap in
    a jax.experimental.multihost_utils broadcast if desired.
    """
    os.makedirs(output_dir, exist_ok=True)
    shard_file = os.path.join(output_dir, f"results_shard_{process_id}.json")
    tmp_file = shard_file + f".tmp.{os.getpid()}"
    with open(tmp_file, "w") as fh:
        json.dump({str(k): v for k, v in local_results.items()}, fh)
    os.replace(tmp_file, shard_file)  # atomic publish
    if process_id != 0:
        return None
    merged = {}
    deadline = time.monotonic() + timeout_s
    for p in range(num_processes):
        path = os.path.join(output_dir, f"results_shard_{p}.json")
        while not os.path.exists(path):
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"results shard {p} missing after {timeout_s:.0f}s "
                    f"({path}); refusing to emit an incomplete panel")
            time.sleep(0.05)
        with open(path) as fh:
            merged.update(json.load(fh))
    return merged


def run_sharded_panel(ref_vntrs, target_vntr_ids, alignment_file: str,
                      working_dir: str, config, process_id: int = 0,
                      num_processes: int = 1, outfmt: str = "text",
                      device="cuda"):
    """Genotype this host's locus shard and gather to host 0.

    The gather merges the analyzer's STRUCTURED per-locus records
    (vid -> {copy_numbers, recruited, spanning, flanking, ml, error}) —
    never the rendered output stream, which stays display-only.  This
    makes every ``outfmt`` mergeable and immune to multi-line or error-row
    formats (an earlier stdout line-pair zip silently mispaired those).
    Returns host 0's merged {vid: record} dict, None on other hosts.
    ``device`` is the analyzer's (``cuda`` unless the caller asks for the
    CPU); processes on one card each hold their own CUDA context."""
    import io
    from advntr_tpu_torch.engine.analyzer import GenomeAnalyzer
    my_loci = shard_loci(list(target_vntr_ids), process_id, num_processes)
    out = io.StringIO()
    analyzer = GenomeAnalyzer(ref_vntrs, my_loci, working_dir, outfmt,
                              config=config, input_file=alignment_file,
                              out=out, device=device)
    if num_processes > 1:
        # per-shard result checkpoint: shard processes sharing a
        # working_dir must not interleave resume records in one file
        analyzer.checkpoint_suffix = f".shard{process_id}"
    records = analyzer.find_repeat_counts_from_alignment_file(alignment_file)
    return gather_results(records, process_id, num_processes,
                          working_dir + "/shards")
