"""On the card: one short run of the first cell is correct and names the
card.  Skips without a CUDA device; run on the card with
`python3 -m pytest wgbs_bench/tests -m chip`."""
import argparse

import pytest


@pytest.mark.chip
def test_first_cell_on_the_card(card):
    from wgbs_bench import run

    opts = argparse.Namespace(workload="se150-dir.bulk", seed=2**31 + 3,
                              seconds=3.0, trace=0, control=False)
    result, info = run.run(opts, card)
    assert result["correct"] is True, info["check"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["reads_per_s"]["value"] > 0
