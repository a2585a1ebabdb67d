"""No module that the harness, the program it drives or the reference
loads has the top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro``
(compared whole: ``repro_torch`` is the port).  Checked in a fresh
process, since the test process itself may hold JAX for other tests."""
import json
import os
import subprocess
import sys

from perfbench.core import bench

SCRIPT = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import runpy
runpy.run_path({run!r}, run_name="perfbench_run_module")
import torch
torch.set_num_threads(1)
from perfbench.conftest import TINY_SEED, tiny
from perfbench.core import bench
from perfbench import fleet_control
cell = tiny(bench.find_cell(bench.load_benchmark(), "ds16.stream"))
driver = bench.driver_of(cell)
out = driver.run(cell, TINY_SEED, 0.0, True, "cpu", 0.0, max_windows=1)
for m in cell.end_to_end + cell.per_layer:
    bench.metric_reader(m["name"])
print(json.dumps({{"forbidden": bench.forbidden_loaded(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "correct": all(c.ok for c in out.checks)}}))
"""


def test_no_jax_or_jax_package_in_a_run():
    code = SCRIPT.format(root=str(bench.ROOT), src=str(bench.ROOT / "src"),
                         run=str(bench.BENCH_DIR / "run.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "repro_torch" in got["tops"] and "perfbench" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])
    assert got["correct"]
