"""App annotations whose promise the port cannot keep yet raise PlanError
when the app is created, naming the later slice, as tables and triggers
do: `@app:durability` (the JAX package's write-ahead log of admitted
frames, siddhi_tpu/core/runtime.py:262) and `@app:strictAnalysis` (its
deploy-time static analysis, :411).  `@app:durability('off')` promises no
log and builds."""
import pytest

import siddhi_tpu_torch
from siddhi_tpu_torch.core.planner import PlanError
from siddhi_tpu_torch.replay import C1, C4, C4_HEAD


@pytest.mark.parametrize("app", [C1, C4_HEAD + C4], ids=["filter", "c4"])
@pytest.mark.parametrize("head,policy", [
    ("@app:durability('batch')\n", "batch"),
    ("@app:durability('fsync')\n", "fsync"),
    ("@app:durability\n", "batch"),
], ids=["batch", "fsync", "default"])
def test_durability_raises_at_create(head, policy, app):
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(PlanError, match=rf"@app:durability\('{policy}'\) "
                       r"\(the write-ahead log .*\) is a later slice"):
        mgr.create_app_runtime(head + app)


@pytest.mark.parametrize("app", [C1, C4_HEAD + C4], ids=["filter", "c4"])
def test_strict_analysis_raises_at_create(app):
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    with pytest.raises(PlanError, match=r"@app:strictAnalysis .* is a "
                       r"later slice"):
        mgr.create_app_runtime("@app:strictAnalysis\n" + app)


def test_durability_off_builds_and_runs():
    """'off' asks for no log: the app builds and filters as without it."""
    mgr = siddhi_tpu_torch.SiddhiManager(device="cpu")
    rt = mgr.create_app_runtime("@app:durability('off')\n" + C1)
    out = []
    rt.add_callback("Out", lambda evs: out.extend(e.data for e in evs))
    h = rt.input_handler("StockStream")
    h.send(("A", 101.0, 1), timestamp=1000)
    h.send(("B", 99.0, 1), timestamp=1001)
    rt.flush()
    assert out == [("A", 101.0, 1)]
