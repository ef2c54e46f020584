"""On the card only (skipped elsewhere): one short run of the first cell,
as the command runs it, comes out correct."""

import time

from benchmark import harness


def test_a_short_run_of_the_first_cell(card):
    wl = harness.workload("scale2x.b16_512")
    result = harness.run_cell(wl, 2 ** 31 + 5, 2.0, False, card,
                              time.perf_counter(), log=lambda line: None)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["out_mp_per_s"]["value"] > 0
