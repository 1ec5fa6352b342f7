"""The kernel-variant timing tool's source edits, on the CPU (its builds
and timings need a card)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from time_kernel_variants import variant_source  # noqa: E402

CU = os.path.join(ROOT, "redgnn_tpu_torch", "csrc", "segment_sum_sorted.cu")


def test_variant_source_sets_named_constants(tmp_path):
    path = variant_source(":kSegs=32,kRowsAhead=4", str(tmp_path), 0)
    src = open(path).read()
    assert "constexpr int kSegs = 32;" in src
    assert "constexpr int kRowsAhead = 4;" in src
    assert "constexpr int kWarps = 8;" in src
    # nothing else of the kernel changed
    base = open(CU).read()
    assert len(src.splitlines()) == len(base.splitlines())
    assert variant_source("", str(tmp_path), 1) == CU


@pytest.mark.parametrize("spec", [":kNoSuch=3", ":kSegs", ":kSegs=16,kWarps"])
def test_variant_source_refuses_bad_specs(tmp_path, spec):
    # a name the source does not define once, or an item without a value
    with pytest.raises(ValueError):
        variant_source(spec, str(tmp_path), 0)
