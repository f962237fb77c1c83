"""``python -m noise_flow_tpu_torch.probes.mesh --steps_per_call K`` on the
CPU: 2 gloo ranks, which run a group of K as K eager steps, so every field
that only a graph on the card can read is present and null; the N-rank run
at K against the same ranks at K = 1 is the same bits."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400
GRAPH_FIELDS = ("graph_step_ms", "replay_device_ms", "replay_allreduces",
                "replay_allreduce_device_ms", "nccl_kernels")


def test_mesh_probe_steps_per_call_on_the_cpu(tmp_path):
    out = tmp_path / "mesh.json"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    done = subprocess.run(
        [sys.executable, "-m", "noise_flow_tpu_torch.probes.mesh", "--device", "cpu",
         "--ranks", "2", "--steps_per_call", "2", "--global_batch", "8", "--epochs", "1",
         "--no_dncnn", "--work", str(tmp_path / "work"), "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert done.returncode == 0, done.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["steps_per_call"] == 2 and report["backend"] == "gloo"
    assert "dncnn" not in report
    for path in ("plain", "oneshot"):
        runs = report[path]["runs"]
        assert set(runs) == {"2_2", "1_2", "2_1"}
        # one train row (one epoch: 2 groups of 2 and a 6-step tail)
        assert all(len(r["train"]) == 1 for r in runs.values())
        gve = report[path]["graph_vs_eager"]
        assert gve["same_bits"] and gve["first_differing"] is None, gve
        assert report[path]["weights_ratio"] <= 1.0
        for times in report["times"] + [report["one_rank"]]:
            t = times[path]
            assert t["step_ms"] > 0
            assert all(f in t and t[f] is None for f in GRAPH_FIELDS), t
    assert [t["plain"]["allreduces"] for t in report["times"]] == [65.0, 65.0]
    assert [t["oneshot"]["allreduces"] for t in report["times"]] == [1.0, 1.0]
