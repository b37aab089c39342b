"""The application layer of surf_tpu_torch (app/image_io.py, config.py,
metrics.py, profiling.py, cli.py and scene/loader.py) on the CPU, at
tests/test_app.py's and tests/test_loader.py's sizes: the PNG bytes and the
scene files against surf_tpu's, the CLI end to end, frames in flight,
animation, --shard over 2 spawned gloo ranks, and the CLI's image against
surf_tpu's CLI."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from surf_tpu.app import image_io as jimage_io
from surf_tpu.app.cli import main as jmain
from surf_tpu.scene.loader import camera_from_spec as jcamera_from_spec
from surf_tpu.scene.loader import load_scene_file as jload_scene_file
from surf_tpu_torch.app import image_io
from surf_tpu_torch.app.cli import main
from surf_tpu_torch.app.config import AppConfig
from surf_tpu_torch.app.metrics import MetricsLog
from surf_tpu_torch.app.profiling import device_memory_stats, stage_timer, torch_trace
from surf_tpu_torch.dist.launch import run_local_ranks
from surf_tpu_torch.scene.loader import camera_from_spec, load_scene_file
from surf_tpu_torch.wavefront.accumulator import Accumulator
from test_loader import DOC

warnings.filterwarnings("ignore", category=RuntimeWarning)
# One intra-op thread: tier-1 runs six pytest workers on the machine's
# cores, and torch's default of one thread per core oversubscribes them.
torch.set_num_threads(1)

BOX16 = ["--scene", "box", "--width", "16", "--height", "16", "--spp", "1"]
CPU_ARGS = ["--device", "cpu"]


def _cli(*args) -> None:
    assert main([*CPU_ARGS, *args]) == 0


def test_image_io_matches_jax(tmp_path):
    """tonemap, rgba_to_u32 and the PNG file's bytes equal surf_tpu's for
    the same image; the reader round-trips; .npy writes the radiance."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.2, 1.6, (13, 17, 3)).astype(np.float32)
    assert np.array_equal(image_io.tonemap(img), jimage_io.tonemap(img))
    assert np.array_equal(image_io.tonemap(img, False), jimage_io.tonemap(img, False))
    rgba = rng.uniform(-0.5, 1.5, (64, 4)).astype(np.float32)
    assert np.array_equal(image_io.rgba_to_u32(rgba), jimage_io.rgba_to_u32(rgba))
    ours, theirs = tmp_path / "a.png", tmp_path / "b.png"
    image_io.save_image(str(ours), img)
    jimage_io.save_image(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    assert np.array_equal(image_io.read_png(str(ours)), image_io.tonemap(img))
    image_io.save_image(str(tmp_path / "x.npy"), img)
    assert np.array_equal(np.load(tmp_path / "x.npy"), img)
    with pytest.raises(ValueError):
        image_io.save_image(str(tmp_path / "x.jpg"), img)


def test_config_round_trip(tmp_path):
    """AppConfig through JSON; ``device`` (default cuda) in place of JAX's
    ``backend``."""
    assert AppConfig().device == "cuda" and not hasattr(AppConfig(), "backend")
    cfg = AppConfig(scene="box", width=32, height=32, spp=4, device="cpu", shard=True)
    p = tmp_path / "c.json"
    p.write_text(cfg.to_json())
    assert AppConfig.from_file(str(p)) == cfg


def test_metrics_log_shape(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLog(64, 64, path)
    m = log.tick(spp=2, total_samples=2, energy=123.0, waves=3.0)
    assert m.total_samples == 2 and m.extra == {"waves": 3.0}
    assert "Lumen" in m.format_line()
    rec = json.loads(open(path).read().strip())
    assert rec["energy"] == 123.0 and rec["frame"] == 0


def test_loader_matches_jax(tmp_path):
    """tests/test_loader.py's document: the same meshes, materials,
    transforms, lights, background and camera as surf_tpu's loader, and
    the CLI renders it (8x8) to a finite image."""
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(DOC))
    scene, spec = load_scene_file(str(p))
    jscene, jspec = jload_scene_file(str(p))
    assert spec == jspec and scene.light_indices == jscene.light_indices == [1]
    assert len(scene.instances) == len(jscene.instances) == 2
    for a, b in zip(scene.instances, jscene.instances):
        assert np.array_equal(a.transform, b.transform)
        for k in ("v0", "v1", "v2", "n0", "n1", "n2"):
            assert np.array_equal(getattr(a.mesh, k), getattr(b.mesh, k))
        for k in ("albedo", "emission_color", "emission_strength", "absorption"):
            assert np.array_equal(getattr(a.material, k), getattr(b.material, k))
    for k in ("type", "color", "gradient_a", "gradient_b"):
        assert np.array_equal(getattr(scene.background, k), getattr(jscene.background, k))
    cam, jcam = camera_from_spec(spec, 16, 16), jcamera_from_spec(jspec, 16, 16)
    for k in ("position", "forward", "up", "fov_y", "focal_length", "defocus_angle"):
        assert np.array_equal(getattr(cam, k), getattr(jcam, k))
    out = tmp_path / "o.npy"
    _cli("--scene", str(p), "--width", "8", "--height", "8", "--output", str(out))
    img = np.load(out)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.sum() > 0


def test_cli_end_to_end(tmp_path):
    """PNG, checkpoint and metrics, then --resume; --device cuda without a
    card raises (no fallback to the CPU)."""
    out, ckpt, metrics = tmp_path / "o.png", tmp_path / "acc.npz", tmp_path / "m.jsonl"
    _cli(*BOX16, "--frames", "2", "--output", str(out), "--checkpoint", str(ckpt),
         "--metrics-jsonl", str(metrics))
    img = image_io.read_png(str(out))
    assert img.shape == (16, 16, 3) and img.max() > 0
    assert Accumulator.load(str(ckpt)).total_samples == 2
    assert len(metrics.read_text().splitlines()) == 2
    _cli(*BOX16, "--frames", "1", "--checkpoint", str(ckpt), "--resume", "--wave-stats")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([*BOX16, "--frames", "1"])


def test_cli_frames_in_flight_matches_blocking(tmp_path):
    """--frames-in-flight 3 accumulates the image of the blocking loop
    exactly, static and with --animate (the accumulator clear deferred to
    drain time)."""
    outs = {}
    for flight in (1, 3):
        for tag, extra in (("static", []), ("anim", ["--animate"])):
            out = tmp_path / f"o{flight}{tag}.npy"
            _cli(*BOX16, "--frames", "3", "--output", str(out), "--frames-in-flight",
                 str(flight), *extra)
            outs[(flight, tag)] = np.load(out)
    assert np.array_equal(outs[(1, "static")], outs[(3, "static")])
    assert np.array_equal(outs[(1, "anim")], outs[(3, "anim")])
    assert not np.array_equal(outs[(1, "static")], outs[(1, "anim")])


def test_cli_animate_rebuild(tmp_path):
    """tests/test_animation.py:36: 3 frames with a full SAH rebuild each."""
    out = tmp_path / "o.npy"
    _cli("--scene", "box", "--width", "8", "--height", "8", "--spp", "1", "--frames", "3",
         "--animate", "--rebuild-bvh", "--defer", "--output", str(out))
    assert np.isfinite(np.load(out)).all()


def test_cli_shard_matches_unsharded(tmp_path):
    """--shard over 2 spawned gloo ranks, animated: rank 0 writes the
    image, equal to the unsharded CLI's."""
    args = [*CPU_ARGS, *BOX16, "--frames", "2", "--animate"]
    out = tmp_path / "sharded.npy"
    assert run_local_ranks(ranks.sharded_cli, 2, tmp_path / "ranks", 300,
                           argv=[*args, "--output", str(out)]) == [0, 0]
    ref = tmp_path / "single.npy"
    assert main([*args, "--output", str(ref)]) == 0
    assert np.array_equal(np.load(out), np.load(ref))


def test_cli_matches_jax_cli(tmp_path):
    """The port's CLI image against surf_tpu's for the same arguments, at
    tests/test_torch_render.py:59-60's gate."""
    args = [*BOX16, "--frames", "2"]
    ours, theirs = tmp_path / "ours.npy", tmp_path / "theirs.npy"
    _cli(*args, "--output", str(ours))
    assert jmain([*args, "--output", str(theirs)]) == 0
    img, ref = np.load(ours), np.load(theirs)
    diff = np.abs(ref - img).max(axis=2)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(ref.sum() - img.sum()) / abs(ref.sum()) < 0.01


def test_profiling_on_cpu(tmp_path):
    """stage_timer records the stage; device_memory_stats has JAX's three
    keys, None on the CPU; torch_trace writes a Chrome trace."""
    times = {}
    with stage_timer("stage", times, "cpu"):
        torch.ones(64).sum()
    assert times["stage"] > 0
    assert device_memory_stats("cpu") == dict.fromkeys(
        ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"))
    with torch_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
