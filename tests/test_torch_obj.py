"""The port's .obj import and export against tpurt's: the inline cases of
tests/test_utils.py, a file written and read back at scale, the C++ parse
against the numpy parse, and a scene built from a file rendered by both."""
import numpy as np
import pytest
import torch

import tpurt.render as jrender
from tpurt.core.types import RenderConfig as JRenderConfig
from tpurt.scene import meshes as jmeshes
from tpurt.scene import obj as jobj
from tpurt.scene.scene import Camera as JCamera
import tpurt_torch
from tpurt_torch.bridge import leaves_as_numpy
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.scene import obj as tobj
from tpurt_torch.scene.scene import Camera

import torch_one_thread  # noqa: F401  (one PyTorch thread)

ATOL = 2e-4  # the port's colour bar (tests/test_kernels.py)

INLINE = {
    # tests/test_utils.py:OBJ: a quad fan, two groups, negative indices
    "basic": ["# cube-ish sample", "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0",
              "vt 0 0", "vt 1 0", "vt 1 1", "vn 0 0 1", "usemtl red",
              "f 1/1/1 2/2/1 3/3/1 4/1/1", "usemtl blue", "f -4 -3 -2"],
    # a position with two uvs: a texture seam
    "uv_seam": ["v 0 0 0", "v 1 0 0", "v 0 1 0", "v 1 1 0",
                "vt 0 0", "vt 1 0", "vt 0 1", "vt 0.25 0.75",
                "f 1/1 2/2 3/3", "f 2/4 4/2 3/3"],
    # mixed index styles, negative indices, normals of length 2
    "tricky": ["# tricky", "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0", "v 0 0 1",
               "vt 0 0", "vt 1 0", "vt 1 1", "vn 0 0 2", "vn 1 0 0", "usemtl red",
               "f 1/1/1 2/2/1 3/3/1 4/1/1", "f -5/-3/-2 2/2 3//1", "usemtl blue",
               "f 1 2 5", "f 3/2/2 4/3/2 5/1/2"],
    # a trailing slash parses as no uv
    "trailing_slash": ["v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0", "vt 0.25 0.75",
                       "f 1/ 2/ 3/", "f 2/1 3/ 4/1"],
}


def _assert_same_mesh(got, want):
    for k in ("vertices", "triangles", "uvs", "tri_group"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if want["normals"] is None:
        assert got["normals"] is None
    else:
        np.testing.assert_array_equal(got["normals"], want["normals"])
    assert got["groups"] == want["groups"]


@pytest.mark.parametrize("name", list(INLINE))
def test_load_obj_lines_equal_tpurt(name):
    _assert_same_mesh(tobj.load_obj(INLINE[name]), jobj.load_obj(INLINE[name]))


@pytest.mark.parametrize("name", list(INLINE))
def test_native_parse_equals_numpy_parse(tmp_path, name):
    path = tmp_path / f"{name}.obj"
    path.write_text("\n".join(INLINE[name]) + "\n")
    native = tobj.load_obj(str(path))
    _assert_same_mesh(native, tobj.parse_obj_lines(INLINE[name]))
    _assert_same_mesh(tobj.load_obj(path), native)          # a pathlib.Path too
    _assert_same_mesh(native, jobj.load_obj(str(path)))


def test_load_obj_of_a_missing_file_raises(tmp_path):
    with pytest.raises(OSError, match="cannot read"):
        tobj.load_obj(str(tmp_path / "missing.obj"))


def test_obj_written_and_read_at_scale(tmp_path):
    """An 81,920-triangle mesh with uvs and normals: the port writes tpurt's
    file byte for byte and reads back tpurt's arrays, and the positions
    survive the text exactly."""
    v, t = jmeshes.displaced_blob(6, radius=1.0, center=(0, 1.1, 0))
    rng = np.random.default_rng(3)
    uvs = rng.uniform(size=(len(v), 2)).astype(np.float32)
    nrm = rng.normal(size=(len(v), 3)).astype(np.float32)
    group = (np.arange(len(t)) // 20000).astype(np.int32)
    ours, theirs = tmp_path / "ours.obj", tmp_path / "theirs.obj"
    tobj.save_obj(str(ours), v, t, uvs=uvs, normals=nrm, tri_group=group)
    jobj.save_obj(str(theirs), v, t, uvs=uvs, normals=nrm, tri_group=group)
    assert ours.read_bytes() == theirs.read_bytes()
    mesh = tobj.load_obj(str(ours))
    _assert_same_mesh(mesh, jobj.load_obj(str(theirs)))
    assert mesh["triangles"].shape == t.shape
    np.testing.assert_array_equal(mesh["vertices"][mesh["triangles"]], v[t])
    np.testing.assert_array_equal(mesh["uvs"][mesh["triangles"]], uvs[t])
    assert mesh["groups"] == ["default", "mat0", "mat1", "mat2", "mat3", "mat4"]


def test_scene_from_obj_renders_tpurts_image(tmp_path):
    v, t = jmeshes.displaced_blob(3, radius=1.0, center=(0, 1.1, 0))
    path = str(tmp_path / "blob.obj")
    tobj.save_obj(path, v, t)
    mats = [{"ka": 0.1, "kd": (0.6, 0.6, 0.6)}]
    lights = [((4.0, 6.0, 4.0), (1.0, 1.0, 1.0))]
    eye, look = (0.0, 1.8, 4.2), (0.0, 1.0, 0.0)
    js = jobj.scene_from_obj(path, materials=mats, lights=lights,
                             camera=JCamera.make(eye, look, fov_y=np.pi / 4))
    ts = tobj.scene_from_obj(path, materials=mats, lights=lights,
                             camera=Camera.make(eye, look, fov_y=np.pi / 4, device="cpu"),
                             device="cpu")
    assert ts.vertices.device == torch.device("cpu") and ts.smooth
    got = leaves_as_numpy(ts)
    for k in ("vertices", "triangles", "vnormals", "uvs", "tri_mat"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)), err_msg=k)
    cfg = RenderConfig(width=16, height=16, max_depth=0)
    ref = np.asarray(jrender.render(js, JRenderConfig(width=16, height=16, max_depth=0,
                                                      backend="oracle")))
    img = tpurt_torch.render(ts, cfg)
    np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=ATOL)
