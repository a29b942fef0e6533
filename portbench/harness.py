"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line.

A *call* is one sample genotyped by the port's own entry,
``advntr_tpu_torch.cli.main(["genotype", ...])``, in the run's process,
with a fresh working directory, back to back (one worker, a closed loop).
The window stops taking new work at ``--seconds`` and finishes the work
in flight: the call, or, where the traffic's ``window_unit`` is
``locus``, the locus.  ``loci_per_s`` is every locus finished, over the
time from the window's start to the last finish.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import generate, roofline, spans, trace
from portbench.reference import check

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "advntr_tpu")
# the port's sources that decide what a bank holds
BANK_SOURCES = ("models", "engine/finder.py", "native_bridge.py",
                "csrc/model_closure.cc")


class WindowClosed(Exception):
    """Raised after the locus in flight when the window has closed."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_cell(name: str, manifest: dict) -> dict:
    cell = next((w for w in manifest["workloads"] if w["name"] == name),
                None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    read = lambda *p: json.loads((PKG.joinpath(*p)).read_text())
    spec = {"cell": cell,
            "workload": read("workloads", f"{name}.json"),
            "config": read("configs", f"{cell['config']}.json"),
            "traffic": read("traffic", f"{cell['traffic']}.json"),
            "metrics": [m for m in manifest["per_layer"]
                        if name in m.get("workloads", [name])]}
    spec["config_bytes"] = (PKG / "configs" /
                            f"{cell['config']}.json").read_bytes()
    return spec


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _bank_dir(spec: dict) -> Path:
    import advntr_tpu_torch
    port = Path(advntr_tpu_torch.__file__).parent
    h = hashlib.sha256(spec["config_bytes"])
    h.update((PKG / "generate.py").read_bytes())
    for rel in BANK_SOURCES:
        p = port / rel
        for f in sorted(p.rglob("*.py")) if p.is_dir() else [p]:
            h.update(f.read_bytes())
    return PKG / ".cache" / f"bank-{spec['cell']['config']}-" \
        f"{h.hexdigest()[:16]}"


def _ensure_bank(spec: dict, db: str) -> Path:
    """The cell's prebuilt model bank, built by the port's own
    ``buildbank`` into a fixed directory of the checkout on the first run
    and reused after, as a user builds a bank once."""
    from advntr_tpu_torch import cli
    final = _bank_dir(spec)
    if (final / "complete").exists():
        return final / "model_bank"
    staging = final.with_name(final.name + ".building")
    shutil.rmtree(staging, ignore_errors=True)
    staging.mkdir(parents=True)
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    cli.main(["buildbank", "-m", db, "--working_directory", str(staging),
              "-l", str(spec["config"]["panel"]["read_length"]),
              "-t", str(workers)])
    (staging / "complete").write_text("built\n")
    shutil.rmtree(final, ignore_errors=True)
    os.replace(staging, final)
    return final / "model_bank"


def _parse_text(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    lines = Path(path).read_text().split("\n")
    return {int(lines[i]): lines[i + 1] for i in range(0, len(lines) - 1, 2)
            if lines[i].strip()}


STAT_KEYS = ("logp", "repeats", "n_matches", "repeat_bp", "left_flank_bp",
             "right_flank_bp", "left_flank_matches", "right_flank_matches")


class Run:
    def __init__(self, spec: dict, seed: int, seconds: float, trace_on: bool,
                 device: str = "cuda", t_process: float | None = None):
        self.spec, self.seed, self.seconds = spec, seed, seconds
        self.trace_on, self.device = trace_on, device
        self.t_process = t_process
        self.cfg, self.tr = spec["config"], spec["traffic"]
        self.rec = spans.Recorder()
        self.captures: dict = {}      # call -> vid -> captured output
        self.done: list = []          # (call, vid, time finished)
        self.current = None           # (call, vid) in flight (long reads)
        self.deadline = None
        self.work = {"decode": [0.0, 0.0], "align": [0.0, 0.0]}
        self.profiling = False
        self.prof = None
        self.written = 0              # bytes the calls left on disk
        self.tmp = None

    # ---- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from advntr_tpu_torch import cli  # noqa: F401 (the port, once)
        import torch
        if self.device == "cuda":
            from advntr_tpu_torch.ops import _kernels
            _kernels.build()
            torch.cuda.init()
        from advntr_tpu_torch import native_bridge
        native_bridge.load_closure()
        self.tmp = tempfile.mkdtemp(prefix="portbench-")
        self.loci = generate.make_panel(self.cfg)
        self.db = os.path.join(self.tmp, "panel.db")
        generate.write_db(self.db, self.loci)
        scale = self.cfg["panel"]["loci"] / self.cfg["published"]["loci"]
        self.samples = [self._sample(f"sample{s}", self.loci, s, scale)
                        for s in range(self.tr["samples"])]
        # the warm-up's own small sample: its loci's reads alone
        self.warm_sample = self._sample(
            "warmup", self.loci[:self.tr["warmup_loci"]], -1, 0.0)
        self.bank = None
        if self.tr["models"] == "bank":
            self.bank = _ensure_bank(self.spec, self.db)
        self._install_hooks()
        self.power = _power_limit() if self.device == "cuda" else "cpu"

    def _sample(self, label: str, loci, index: int, scale: float) -> dict:
        reads, truth, placed = generate.make_sample(loci, self.tr, self.seed,
                                                    index, scale)
        if self.tr["reads"]["kind"] == "short":
            path = os.path.join(self.tmp, label + ".bam")
            generate.write_bam(path, reads, placed,
                               mapq=self.tr["reads"]["mapq"])
        else:
            path = os.path.join(self.tmp, label + ".fa")
            generate.write_fasta(path, reads)
        return {"path": path, "reads": reads, "truth": truth,
                "placed": placed}

    def _install_hooks(self) -> None:
        rec, run = self.rec, self
        an = "advntr_tpu_torch.engine.analyzer"
        fi = "advntr_tpu_torch.engine.finder"

        def counts_before(args):
            finder, reads, row_info, stats = args[:4]
            if run.current is None:
                return
            R = len(row_info)
            run.captures[run.current[0]][finder.reference_vntr.id] = {
                "mapped": [r[0] for r in reads if r[2]],
                "recruited": [r[0] for r in reads if not r[2]],
                "rows": list(row_info),
                "stats": {k: np.array(stats[k][:R]) for k in STAT_KEYS}}
        rec.hook(fi, "VNTRFinder.counts_from_stats", before=counts_before)

        def pacbio_before(args):
            _, vid, unmapped = args[:3]
            run.current = (run.current[0], vid)
            run.captures[run.current[0]][vid] = {
                "recruited": [n for n, _ in unmapped], "windows": []}

        def pacbio_after(args, out):
            if run.profiling and time.perf_counter() - run.trace_t0 >= \
                    run.tr["trace_seconds"]:
                run._stop_profile()
            if run.tr["window_unit"] != "locus":
                return
            run.done.append((run.current[0], args[1], time.perf_counter()))
            if run.deadline is not None and \
                    time.perf_counter() >= run.deadline:
                raise WindowClosed()
        rec.hook(an, "GenomeAnalyzer._genotype_pacbio_locus",
                 before=pacbio_before, after=pacbio_after)

        def score_after(args, out):
            if run.current is None or len(run.current) < 2:
                return
            cap = run.captures[run.current[0]].get(run.current[1])
            scored, stats = out
            if cap is None or stats is None:
                return
            # one row a window; the batch behind them is padded
            n = len(args[1])
            cap["windows"] = [(w, s.upper()) for w, s in args[1]]
            cap["logp"] = np.array(stats["logp"][:n], dtype=np.float64)
            cap["repeats"] = [int(x) for x in stats["repeats"][:n]]
        rec.hook(fi, "VNTRFinder.score_reads", after=score_after)

        # the work of the traced stretch, from the inputs each call took
        L = self.cfg["panel"].get("read_length", 0)

        def count_decode(args):
            if not run.profiling:
                return
            if len(args) >= 3 and isinstance(args[2], dict):   # a group
                for vid in args[1]:
                    finder, _, _, rows, _ = args[2][vid]
                    W = len(finder.reference_vntr.pattern)
                    C = int(round(L / W + 0.5))
                    o, b = roofline.decode_work(L, L, W, C,
                                                [len(r) for r in rows])
                    run.work["decode"][0] += o
                    run.work["decode"][1] += b
            elif len(args) >= 2:                              # long reads
                finder, windows = args[0], args[1]
                if not windows:
                    return
                W = len(finder.reference_vntr.pattern)
                longest = max(0, max(len(s) - 100 for _, s in windows))
                C = max(1, int(round(longest / float(W))))
                o, b = roofline.decode_work(100, 100, W, C,
                                            [len(s) for _, s in windows])
                run.work["decode"][0] += o
                run.work["decode"][1] += b
        rec.hook(an, "GenomeAnalyzer._dispatch_group", before=count_decode)
        rec.hook(fi, "VNTRFinder.score_reads", before=count_decode)

        def count_align(args):
            if run.profiling:
                o, b = roofline.align_work([len(r) for r in args[0]],
                                           [len(p) for p in args[1]])
                run.work["align"][0] += o
                run.work["align"][1] += b
        rec.hook(fi, "anchor_probes_batch", before=count_align)
        rec.install()

    # ---- calls ------------------------------------------------------------

    def call_loci(self, i: int) -> list[int]:
        vids = [lc.vid for lc in self.loci]
        n = self.tr["loci_per_call"]
        if self.tr.get("rotate"):
            start = (i * n) % len(vids)
            return (vids + vids)[start:start + n]
        return vids[:n]

    def call(self, i: int, vids: list[int], label) -> None:
        """One sample genotyped in a fresh working directory."""
        from advntr_tpu_torch import cli
        sample = self.warm_sample if label == "warmup" else \
            self.samples[i % len(self.samples)]
        wd = os.path.join(self.tmp, f"call{label}")
        os.makedirs(wd)
        if self.bank is not None:
            os.symlink(self.bank, os.path.join(wd, "model_bank"))
        out = os.path.join(wd, "out.txt")
        fill = {"sample": sample["path"], "db": self.db, "workdir": wd,
                "out": out, "vids": ",".join(map(str, vids)),
                "device": self.device}
        argv = [a.format(**fill) for a in self.tr["argv"]]
        self.captures[label] = {}
        self.current = (label,)
        closed = False
        try:
            cli.main(argv)
        except WindowClosed:
            closed = True
        self.current = None
        text = _parse_text(out)
        if self.tr["window_unit"] == "call":
            for vid in vids:
                self.captures[label].setdefault(
                    vid, {"mapped": [], "recruited": [], "rows": None,
                          "no_rows": True})
        for vid, cap in self.captures[label].items():
            cap["call"] = text.get(vid)
            cap["sample"] = i % len(self.samples)
        if self.tr["window_unit"] == "call":
            t = time.perf_counter()
            self.done += [(label, vid, t) for vid in vids]
        self.written += sum(os.path.getsize(os.path.join(d, f))
                            for d, _, files in os.walk(wd) for f in files
                            if not os.path.islink(os.path.join(d, f)))
        if label != "warmup":
            shutil.rmtree(wd, ignore_errors=True)
        if closed:
            raise WindowClosed()

    # ---- profiling --------------------------------------------------------

    def _start_profile(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._stretch = torch.profiler.record_function(trace.STRETCH)
        self._stretch.__enter__()
        self.rec.annotate = True
        self.profiling = True
        self.trace_t0 = time.perf_counter()

    def _stop_profile(self) -> None:
        import torch
        if not self.profiling:
            return
        if self.device == "cuda":
            torch.cuda.synchronize()
        self._stretch.__exit__(None, None, None)
        self.rec.annotate = False
        self.profiling = False
        self.prof.stop()

    # ---- the window -------------------------------------------------------

    def window(self) -> None:
        import torch
        warm = self.tr["warmup_loci"]
        try:
            self.call(0, [lc.vid for lc in self.loci][:warm], "warmup")
        except WindowClosed:
            pass
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.rec.clear()
        self.done.clear()
        self.work = {"decode": [0.0, 0.0], "align": [0.0, 0.0]}
        gc.collect()
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if self.trace_on:
            self._start_profile()
        self.setup_s = self.t_process_age()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds
        i = 0
        while i == 0 or time.perf_counter() < self.deadline:
            vids = self.call_loci(i)
            try:
                self.call(i, vids, i)
            except WindowClosed:
                break
            if self.tr["window_unit"] == "call":
                self._stop_profile()        # the traced stretch: one call
            i += 1
        self._stop_profile()
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.t_end = max((t for _, _, t in self.done), default=None)
        self.deadline = None

    def t_process_age(self) -> float:
        return process_age() if self.t_process is None else \
            time.perf_counter() - self.t_process

    # ---- after the window -------------------------------------------------

    def device_numbers(self) -> dict:
        import torch
        if self.device != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}

    def check(self) -> tuple[bool, list, dict]:
        """Compare a sample of the finished loci, drawn from the seed, with
        the reference; returns (correct, [(name, value, limit)], numbers)."""
        import torch
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
        finished = [(c, v) for c, v, _ in self.done
                    if v in self.captures.get(c, {})]
        per_sample: dict = {}
        for c, v in finished:
            per_sample.setdefault(self.captures[c][v]["sample"], set()).add(v)
        rng = random.Random(self.seed * 7919 + 17)
        k = self.tr["check_loci"]
        chosen = []
        tract = {lc.vid: len(lc.pattern) * lc.ref_copies for lc in self.loci}
        for s in sorted(per_sample):
            # the longest tract finished, and others drawn from the seed
            vids = sorted(per_sample[s], key=lambda v: (-tract[v], v))
            rest = sorted(vids[1:])
            chosen += [(s, vids[0])] + [
                (s, v) for v in rng.sample(rest, min(k - 1, len(rest)))]
        rows = []
        refs: dict = {}
        platform = self.cfg["platform"]
        mins = {}
        for s, v in chosen:
            if s not in refs:
                refs[s] = check.Reference(self.cfg, self.loci,
                                          self.samples[s]["reads"],
                                          self.device,
                                          placed=self.samples[s]["placed"])
            ref = refs[s]
            r = ref.short_locus(v) if platform == "illumina" else \
                ref.long_locus(v)
            for c, vv in finished:
                if vv != v or self.captures[c][v]["sample"] != s:
                    continue
                port = self._port_view(self.captures[c][v], v, mins)
                rows.append(check.compare(platform, port, r))
        numbers = check.combine(rows)
        numbers["loci_checked"] = len(rows)
        limits = self.spec["workload"]["limits"]
        checks = [(name, numbers[name], limits[name]) for name in limits]
        ok = bool(rows) and all(v <= lim for _, v, lim in checks)
        truth_hits = self._truth_agreement()
        return ok, checks, {"numbers": numbers, "truth": truth_hits}

    def _port_view(self, cap: dict, vid: int, mins: dict) -> dict:
        """What the timed call produced for a locus, in the reference's
        terms (the port's statistics through the same read rules)."""
        from portbench.reference import genotype as g
        out = {"recruited": cap["recruited"], "call": cap["call"],
               "mapped": cap.get("mapped", [])}
        out["names"] = out["mapped"] + out["recruited"]
        if "windows" in cap:
            out.update(windows=cap.get("windows", []),
                       logp=cap.get("logp", np.zeros(0)),
                       repeats=cap.get("repeats", []))
            return out
        if cap.get("no_rows"):
            out.update(rows=None, logp=np.zeros(0), verdicts=[])
            return out
        st = cap["stats"]
        R = len(cap["rows"])
        stats = [{k: int(st[k][i]) for k in STAT_KEYS if k != "logp"}
                 for i in range(R)]
        lc = next(x for x in self.loci if x.vid == vid)
        if vid not in mins:
            mins[vid] = tuple(max(5, h) for h in g.homology_runs(
                lc.pattern, lc.left, lc.right))
        seqs = self._seqs(cap["sample"])
        reads = [(n, seqs[n]) for n in out["names"]]
        _, verdicts = g.short_read_call(reads, cap["rows"], stats,
                                        st["logp"].astype(np.float64),
                                        mins[vid])
        out.update(rows=cap["rows"], logp=st["logp"].astype(np.float64),
                   verdicts=verdicts)
        return out

    def _seqs(self, sample: int) -> dict:
        if not hasattr(self, "_seq_maps"):
            self._seq_maps = {}
        if sample not in self._seq_maps:
            self._seq_maps[sample] = dict(self.samples[sample]["reads"])
        return self._seq_maps[sample]

    def failed_loci(self) -> int:
        """Finished loci whose row says Error (a host step failed)."""
        return sum(1 for c, v, _ in self.done
                   if self.captures.get(c, {}).get(v, {}).get("call")
                   == "Error")

    def _truth_agreement(self) -> str:
        agree = total = 0
        for c, v, _ in self.done:
            cap = self.captures.get(c, {}).get(v)
            if cap is None or cap.get("call") is None:
                continue
            want = "/".join(map(str, self.samples[cap["sample"]]["truth"][v]))
            agree += cap["call"] == want
            total += 1
        return f"{agree}/{total}"

    def close(self) -> None:
        self.rec.uninstall()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def metric_context(run: Run, trace_numbers: dict | None) -> dict:
    return {"spans": run.rec.spans, "t0": run.t0, "t_end": run.t_end,
            "loci": len(run.done), "trace": trace_numbers, "work": run.work}


def read_metrics(spec: dict, ctx: dict) -> dict:
    out = {}
    for m in spec["metrics"]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(spec: dict, seed: int, seconds: float, trace_on: bool,
            device: str = "cuda", t_process=None) -> tuple[int, dict | None]:
    """Run a cell; returns (exit code, result or None).  The check lines
    go to standard error."""
    run = Run(spec, seed, seconds, trace_on, device, t_process)
    try:
        run.setup()
        run.window()
        dev = run.device_numbers()
        found = forbidden_modules()
        if found:
            print("portbench: loaded after the window: " + ", ".join(found),
                  file=sys.stderr)
            return 3, None
        if run.t_end is None:
            print("portbench: no locus finished in the window",
                  file=sys.stderr)
            return 4, None
        elapsed = run.t_end - run.t0
        trace_numbers = None
        if trace_on and run.prof is not None:
            path = os.path.join(run.tmp, "trace.json")
            run.prof.export_chrome_trace(path)
            run.prof = None
            trace_numbers = trace.reduce_trace(path, list(spans.LAYERS))
            os.remove(path)
        correct, checks, info = run.check()
        attempted = len(run.done)
        n = info["numbers"]
        print(f"portbench: {spec['cell']['name']} seed {seed}: "
              f"{attempted} loci in {elapsed:.3f} s; truth {info['truth']} "
              f"(information only); {n['loci_checked']} checked; calls "
              f"wrote {run.written / 1e6:.1f} MB; card {run.power}",
              file=sys.stderr)
        if spec["traffic"]["window_unit"] == "locus":
            print("portbench: loci finished at " + " ".join(
                f"{t - run.t0:.2f}" for _, _, t in run.done),
                file=sys.stderr)
        for name, value, limit in checks:
            print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
        result = {"correct": correct, "attempted": attempted,
                  "failed": run.failed_loci(), "metrics": {}, "device": dev}
        if trace_on:
            ctx = metric_context(run, trace_numbers)
            ctx["elapsed"] = elapsed
            result["metrics"] = read_metrics(spec, ctx)
            if trace_numbers is not None:
                result["device"]["busy_s"] = trace_numbers["busy_s"]
                result["device"]["window_s"] = trace_numbers["window_s"]
                result["breakdown"] = {
                    "device_ops": trace_numbers["device_ops"],
                    "idle_gaps": trace_numbers["idle_gaps"]}
        else:
            result["metrics"] = {
                "loci_per_s": {"value": attempted / elapsed,
                               "unit": "loci/s"},
                "setup_s": {"value": run.setup_s, "unit": "s"}}
        result["card"] = run.power
        result["checks"] = {name: {"value": value, "limit": limit}
                            for name, value, limit in checks}
        return 0, result
    finally:
        run.close()
