"""The benchmark's seams in the port: every function that the benchmark
wraps (its layers' spans, ``portbench/spans.py``) or patches (its
harness's hooks and its fault checks) resolves to a callable where the
benchmark looks for it.  ``portbench/spans.py`` skips a function it cannot
find, which leaves the metrics of its layer null without an error; here
such a rename fails."""

import inspect

import pytest

from portbench import spans

AN = "advntr_tpu_torch.engine.analyzer"
FI = "advntr_tpu_torch.engine.finder"
DA = "advntr_tpu_torch.engine.device_analytics"

# the harness's hooks and the fault checks of portbench/tests, beside the
# layers' functions
HOOKS = [(AN, "GenomeAnalyzer._genotype_pacbio_locus"),
         (DA, "read_stats_grouped"),
         (FI, "VNTRFinder.run_device"),
         (FI, "find_genotype")]
SEAMS = sorted({seam for layer in spans.LAYERS.values() for seam in layer}
               | set(HOOKS))

# the leading parameters that the harness's hooks read by position
POSITIONAL = {
    (AN, "GenomeAnalyzer._dispatch_group"):
        ["self", "chunk", "prepped", "wave", "group_size"],
    (AN, "GenomeAnalyzer._genotype_pacbio_locus"):
        ["self", "vid", "unmapped_reads"],
    (FI, "VNTRFinder.counts_from_stats"):
        ["self", "reads", "row_info", "stats"],
    (FI, "VNTRFinder.score_reads"):
        ["self", "mapped_reads", "unmapped_reads"],
}


@pytest.mark.parametrize("module,path", SEAMS,
                         ids=[f"{m.rsplit('.', 1)[1]}:{p}" for m, p in SEAMS])
def test_benchmark_seam_resolves(module, path):
    owner, attr = spans._resolve(module, path)
    assert callable(getattr(owner, attr, None)), (module, path)


@pytest.mark.parametrize("seam", sorted(POSITIONAL),
                         ids=[p for _, p in sorted(POSITIONAL)])
def test_benchmark_hook_arguments_keep_their_places(seam):
    owner, attr = spans._resolve(*seam)
    params = list(inspect.signature(getattr(owner, attr)).parameters)
    want = POSITIONAL[seam]
    assert params[:len(want)] == want
