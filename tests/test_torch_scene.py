"""The port's scene layer against tpurt's: constants, configs 1–5, the
bridge, and the rule that the port imports neither JAX nor tpurt."""
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt import constants as JC
from tpurt.scene import configs as jconfigs
import tpurt_torch
from tpurt_torch import constants as TC
from tpurt_torch.bridge import scene_from_tpurt
from tpurt_torch.scene import configs as tconfigs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _np_dtype(dt):
    if isinstance(dt, torch.dtype):
        return torch.empty(0, dtype=dt).numpy().dtype
    return np.dtype(dt)


def test_constants_equal_tpurt():
    names = [n for n in vars(TC) if n.isupper()]
    assert set(names) == {n for n in vars(JC) if n.isupper()}
    for n in names:
        ours, theirs = getattr(TC, n), getattr(JC, n)
        if n.endswith("DTYPE"):
            assert _np_dtype(ours) == _np_dtype(theirs), n
        else:
            assert ours == theirs, n


def _leaves(scene):
    """(name, numpy array) for every array leaf of a Scene of either
    package, in field order."""
    out = []
    for obj, prefix in ((scene, ""), (scene.materials, "materials."),
                        (scene.camera, "camera.")):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor):
                out.append((prefix + f.name, v.detach().cpu().numpy()))
            elif isinstance(v, jnp.ndarray):
                out.append((prefix + f.name, np.asarray(v)))
    return out


def _assert_same_scene(ts, js):
    ours, theirs = _leaves(ts), _leaves(js)
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (name, a), (_, b) in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for flag in ("smooth", "textured", "n_real_spheres"):
        assert getattr(ts, flag) == getattr(js, flag), flag


#: configs 4 and 5 at a small subdivision: the same code path as the full size
SMALL = {4: {"subdiv": 2}, 5: {"subdiv": 2, "n_blobs": 3}}


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_configs_equal_tpurt(k):
    ts, tcfg = tconfigs.ALL_CONFIGS[k](24, 32, device="cpu", **SMALL.get(k, {}))
    js, jcfg = jconfigs.ALL_CONFIGS[k](24, 32, **SMALL.get(k, {}))
    _assert_same_scene(ts, js)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


#: the port's own configs, which tpurt does not have
PORT_ONLY = {"rtiow"}


def test_config_defaults_equal_tpurt():
    import inspect

    assert set(tconfigs.ALL_CONFIGS) == set(jconfigs.ALL_CONFIGS) | PORT_ONLY
    for k in jconfigs.ALL_CONFIGS:
        ours = {n: p.default for n, p in
                inspect.signature(tconfigs.ALL_CONFIGS[k]).parameters.items()
                if n != "device"}
        theirs = {n: p.default for n, p in
                  inspect.signature(jconfigs.ALL_CONFIGS[k]).parameters.items()}
        assert ours == theirs, k


def test_scene_from_tpurt_carries_uvs_and_textures():
    js, _ = jconfigs.config5_multimesh(8, 8, n_blobs=1, subdiv=1)
    ts = scene_from_tpurt(js, device="cpu")
    _assert_same_scene(ts, js)
    assert ts.textured and ts.textures.shape == (1, 64, 64, 3)
    assert float(ts.uvs.max()) == 8.0 and int(ts.materials.texture_id[0]) == 0


def test_scene_from_tpurt_is_exact():
    js, _ = jconfigs.config2_cornell(8, 8)
    ts = scene_from_tpurt(js, device="cpu")
    _assert_same_scene(ts, js)
    assert ts.vertices.device == torch.device("cpu")


def test_port_imports_without_jax_or_tpurt():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import tpurt_torch, tpurt_torch.render, tpurt_torch.scene.configs\n"
        "import tpurt_torch.bridge, tpurt_torch.kernels.megakernel\n"
        "import tpurt_torch.kernels.build, tpurt_torch.ref.oracle\n"
        "import tpurt_torch.accel.clusters, tpurt_torch.kernels.packc\n"
        "import tpurt_torch.kernels.traversal, tpurt_torch.shading.deferred\n"
        "import tpurt_torch.accel.grid, tpurt_torch.accel.native, tpurt_torch.scene.obj\n"
        "import tpurt_torch.utils.image, tpurt_torch.utils.checkpoint\n"
        "import tpurt_torch.utils.roofline, tpurt_torch.tools.verify, tpurt_torch.cli\n"
        "import tpurt_torch.dist.shard, tpurt_torch.dist.launch, tpurt_torch.dist.failsafe\n"
        "import tpurt_torch.dist.train, tpurt_torch.dist.scene_shard, tpurt_torch.entry\n"
        "assert 'triton' not in sys.modules and tpurt_torch.accel.native._lib is None\n"
        "bad = [m for m in sys.modules if m == 'tpurt' or m.startswith('tpurt.')]\n"
        "assert not bad, bad\n"
        "assert callable(tpurt_torch.render) and callable(tpurt_torch.prepare)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_imports_jax_or_tpurt():
    paths = list((REPO / "tpurt_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"accel", "shading", "kernels", "utils", "tools", "dist"} <= {
        p.parent.name for p in paths}
    assert {"grid.py", "native.py", "obj.py", "image.py", "checkpoint.py", "roofline.py",
            "verify.py", "cli.py", "shard.py", "launch.py", "failsafe.py", "entry.py",
            "scene_shard.py"} <= {
        p.name for p in paths}
    for path in paths:
        text = path.read_text()
        for bad in ("import jax", "from jax", "import tpurt\n", "from tpurt ",
                    "from tpurt."):
            assert bad not in text, f"{path}: {bad!r}"
    assert tpurt_torch.__all__
