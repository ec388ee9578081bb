"""Small sizes of each cell for the benchmark's own tests, run on the CPU:
``python -m pytest benchmark/tests -q`` from the repository's root."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(4)

#: each cell at a size a CPU test holds: the same drivers, checks and limits
SMALL = {
    "zymo-paf-sim": dict(seconds=1.0, overrides={
        "config": {"contigs": {"cA": 100_000}},
        "traffic": {"batchsize": 100, "check_among_first": 1,
                    "corpus": {"n_reads": 2000, "mean_len": 2000.0, "sd_len": 1000.0}},
        # 2,000 strategy rows here against the cell's 619,000: one row
        # near the threshold is a share of 5e-4, above the cell's limit
        "limits": {"strat_mismatch_share": 1e-3}}),
    "chr1-dense-update": dict(seconds=0.5, overrides={
        "config": {"contigs": {"chr1p": 150_000, "chr1q": 100_000}},
        "traffic": {"reads_per_file": 200, "files": 3,
                    "hot": ["chr1p", 40_000, 100_000], "warm_passes": 1,
                    "check_among_first": 5}}),
}
SEED = 2 ** 31 + 12345


@pytest.fixture(params=sorted(SMALL))
def cell(request):
    return request.param
