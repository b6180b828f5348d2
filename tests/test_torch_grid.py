"""The port's uniform grid and its C++ builders against tpurt's: the numpy
grid build (the plain version), the native cluster and grid builds, the
copy of the C++ source, and a build that fails."""
from pathlib import Path

import numpy as np
import pytest

from tpurt.accel import grid as jgrid
from tpurt.accel import native as jnative
from tpurt_torch.accel import native
from tpurt_torch.accel.clusters import LEAF
from tpurt_torch.accel.grid import build_grid
from tpurt_torch.scene import configs as tconfigs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

REPO = Path(__file__).resolve().parents[1]


def _config4_mesh():
    scene, _ = tconfigs.config4_bunny(8, 8, subdiv=2, device="cpu")
    return scene.vertices.numpy(), scene.triangles.numpy()


def _soup():
    """A random triangle soup from a numpy seed: 300 small triangles around
    random centres in a 4 x 2 x 3 box."""
    rng = np.random.default_rng(7)
    centres = rng.uniform((-2, -1, -1.5), (2, 1, 1.5), (300, 1, 3))
    verts = (centres + rng.normal(0, 0.15, (300, 3, 3))).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(900, dtype=np.int32).reshape(300, 3)


MESHES = {"config4_subdiv2": _config4_mesh, "soup": _soup}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_grid_equals_tpurt(mesh):
    verts, tris = MESHES[mesh]()
    ours, theirs = build_grid(verts, tris), jgrid.build_grid(verts, tris)
    np.testing.assert_array_equal(ours.clusters.tri_ids, theirs.clusters.tri_ids)
    np.testing.assert_array_equal(ours.clusters.aabb_lo, theirs.clusters.aabb_lo)
    np.testing.assert_array_equal(ours.clusters.aabb_hi, theirs.clusters.aabb_hi)
    assert ours.dims == theirs.dims
    np.testing.assert_array_equal(ours.origin, theirs.origin)
    np.testing.assert_array_equal(ours.cell_size, theirs.cell_size)
    # every triangle lies in at least one block; a block pads with its first
    ids = ours.clusters.tri_ids
    assert ids.shape[1] == LEAF and set(ids.ravel().tolist()) == set(range(len(tris)))


@pytest.mark.parametrize("builder", ["build_clusters_native", "build_grid_native"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_native_builders_equal_tpurt(mesh, builder):
    # tpurt's bridge falls back to numpy without a word when its build fails:
    # equality below must be C++ against C++
    assert jnative.available()
    verts, tris = MESHES[mesh]()
    ours, theirs = getattr(native, builder)(verts, tris), getattr(jnative, builder)(verts, tris)
    assert ours.tri_ids.dtype == np.int32 and ours.aabb_lo.dtype == np.float32
    np.testing.assert_array_equal(ours.tri_ids, theirs.tri_ids)
    np.testing.assert_array_equal(ours.aabb_lo, theirs.aabb_lo)
    np.testing.assert_array_equal(ours.aabb_hi, theirs.aabb_hi)
    assert set(ours.tri_ids.ravel().tolist()) == set(range(len(tris)))


def test_native_builder_rejects_an_index_outside_the_vertices():
    verts, tris = _soup()
    with pytest.raises(ValueError, match="outside"):
        native.build_clusters_native(verts, np.minimum(tris + 1, 900))


def test_builders_source_is_tpurts_byte_for_byte():
    assert native.SOURCE == REPO / "tpurt_torch" / "native" / "builders.cpp"
    assert native.SOURCE.read_bytes() == (REPO / "tpurt" / "native" / "builders.cpp").read_bytes()


def test_library_builds_into_build_at_first_use():
    so = native.build()
    assert so.is_file() and so.parent.parent == REPO / "build" / "tpurt_torch"
    assert so.parent.name.startswith("native-")


@pytest.mark.parametrize("compiler,message", [
    ("g++-that-is-not-installed", "not found on PATH"),
    ("false", "failed with exit code 1"),
])
def test_a_failed_build_raises(monkeypatch, tmp_path, compiler, message):
    """No cached library hides the compiler: the build directory is empty."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX", compiler)
    monkeypatch.setattr(native, "_lib", None)
    verts, tris = _soup()
    with pytest.raises(RuntimeError, match=message):
        native.build_grid_native(verts, tris)
    assert not any(tmp_path.rglob("*.so"))
