"""The port's headline benchmark (surf_tpu_torch/bench.py) at a test size
on the CPU: bench.py's JSON line with a finite, positive energy; and no
fallback when CUDA is asked for and absent."""

import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from surf_tpu_torch import bench

ROOT = Path(__file__).resolve().parent.parent


def test_bench_prints_bench_py_line():
    out = subprocess.run([sys.executable, "-m", "surf_tpu_torch.bench", "--device", "cpu",
                          "--size", "16", "--spp", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert rec["metric"] == "rays_per_s_chip" and rec["unit"] == "rays/s"
    assert rec["value"] > 0 and rec["vs_baseline"] == pytest.approx(rec["value"] / 2e8)
    d = rec["detail"]
    assert d["device"] == "cpu" and d["config"]["width"] == d["config"]["height"] == 16
    assert d["config"]["algo"] == "bitsru8" and d["config"]["block_rays"] == 2048
    assert len(d["frame_times_s"]) == 2
    assert d["energy"] > 0 and d["energy"] < float("inf")


def test_bench_without_cuda_exits_nonzero():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(SystemExit) as e:
            bench.main(["--device", "cuda"])
    assert e.value.code not in (0, None)
