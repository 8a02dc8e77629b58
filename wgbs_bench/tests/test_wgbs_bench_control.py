"""The control through the harness: `--control` puts the reference with
indels off (the configurations state edit distance with indels) in the
program's place, and the run's own check() and limits find it not correct,
while the program's check of the same run holds."""
from wgbs_bench.tests.helpers import tiny_run


def test_control_is_not_correct(tiny):
    import json
    import os

    path = os.path.join(tiny, "wgbs_bench", "traffic", "tiny-se.json")
    with open(path) as f:
        t = json.load(f)
    t.update(check_sample=t["pool"])    # every read the window sends
    with open(path, "w") as f:
        json.dump(t, f)
    result, info = tiny_run(tiny, "tiny-se.bulk", control=True, seconds=4.0)
    assert result["correct"] is False
    assert result["check"]["mismatched_records"]["value"] >= 1
    assert result["check"]["mismatched_records"]["limit"] == 0
    prog = info["program_check"]
    assert prog["mismatched_records"] == prog["missing_records"] == 0
    assert prog["compared"] == info["check"]["compared"] > 0
