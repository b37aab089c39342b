"""Import hygiene of surf_tpu_torch: the port and chip_smoke.py import
nothing of surf_tpu and nothing of jax, and run from a directory that
holds no surf_tpu at all (a port run then cannot write into it)."""

import ast
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in [*(ROOT / "surf_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"])
FORBIDDEN = ("surf_tpu", "jax")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES)
def test_no_forbidden_import_statements(path):
    """No ``import``/``from`` of surf_tpu or jax anywhere in the file,
    nested imports included (relative imports stay inside the port)."""
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_runs_without_surf_tpu(tmp_path):
    """A copy of the port alone, in a fresh interpreter: every module
    imports, the flattened and the pure two-level compiles run (the native
    builder is compiled into the copy's own _build/), a pure traversal
    runs, and afterwards no surf_tpu or jax module is loaded."""
    shutil.copytree(ROOT / "surf_tpu_torch", tmp_path / "surf_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import torch
        torch.set_num_threads(1)
        import surf_tpu_torch
        for m in pkgutil.walk_packages(surf_tpu_torch.__path__, "surf_tpu_torch."):
            importlib.import_module(m.name)
        assert {"surf_tpu_torch.dist", "surf_tpu_torch.app.cli"} <= set(sys.modules)
        import chip_smoke
        from surf_tpu_torch.accel import instanced
        from surf_tpu_torch.scene import builtin
        from surf_tpu_torch.scene.compile import compile_scene
        cpu = torch.device("cpu")
        ts = compile_scene(builtin.make_indoor_scene(), cpu)
        ps = compile_scene(builtin.make_instanced_stress_scene(8), cpu, two_level="pure")
        o = torch.tensor([[0.0, 8.0, -8.0]]).repeat(256, 1)
        d = torch.nn.functional.normalize(torch.randn(256, 3) * 0.1
                                          + torch.tensor([0.0, -1.0, 1.0]), dim=1)
        hit = instanced.traverse_instanced(ps.inst, o, d, torch.full((256,), 1e30),
                                           torch.ones(256, dtype=torch.bool), block_rays=256)
        assert int((hit.inst >= 0).sum()) > 0
        loaded = [k for k in sys.modules
                  if k in ("surf_tpu", "jax") or k.startswith(("surf_tpu.", "jax."))]
        assert not loaded, loaded
        assert surf_tpu_torch.__file__.startswith(sys.argv[1]), surf_tpu_torch.__file__
        print("OK", ts.num_lights, len(ps.inst.meta.mesh_of))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK 2 10")
    assert not (tmp_path / "surf_tpu").exists()
    assert any((tmp_path / "surf_tpu_torch" / "_build").glob("libsurfnative-*.so"))
