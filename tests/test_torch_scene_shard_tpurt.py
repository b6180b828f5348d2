"""The ring (tpurt_torch.dist.scene_shard) against tpurt: its image and its
gradients of sum(image²) at world 2 over gloo on the CPU, held to tpurt's
replicated clustered render of the renumbered scene and its jax.grad.  A
file of its own: tpurt's side is interpret-mode Pallas and takes a minute,
so `--dist loadfile` puts it on another worker than the ring's other tests
(test_torch_scene_shard.py, which also holds the ring bit for bit to the
port's replicated render).

The ranks import this module afresh, so JAX is imported only inside the
fixture that calls tpurt: a rank must not load JAX.  tpurt's own ring
render is interpret-mode Pallas under shard_map and is not called."""
import functools

import numpy as np
import pytest

from test_torch_scene_shard import (CASES, GRAD_RTOL, TPURT_ATOL, TPURT_LEAVES, TPURT_RTOL,
                                    _case, _grads, _sq)
from tpurt_torch.dist import (prepare_scene_sharded, render_and_grad_scene_sharded,
                              render_scene_sharded_prepared, spawn_ranks)

import torch_one_thread  # noqa: F401  (one PyTorch thread)

ATOL = 2e-4          # the bar of tests/test_kernels.py, against tpurt
# config 4 over two real shards; config 3's one cluster leaves rank 1 a
# duplicate-pad shard with cnt 0, and its bounce is live
TPURT_CASES = ("c4", "c3")
WORLD = 2


def _ring_rank(mesh, names):
    out = {}
    for name in names:
        scene, cfg, plan = _case(name)
        scene2, parts = prepare_scene_sharded(scene, plan.tri_ids, mesh.size)
        img = render_scene_sharded_prepared(scene2, cfg, parts, mesh)
        g = render_and_grad_scene_sharded(scene2, _sq, cfg, parts, mesh)[1]
        out[name] = {"image": img, "grads": _grads(g)}
    return out


@pytest.fixture(scope="module")
def ring():
    return spawn_ranks(_ring_rank, WORLD, "gloo", TPURT_CASES, device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def tpurt_refs():
    """{case: (image, grads)}: tpurt's replicated clustered render of the
    renumbered scene (interpret mode) and jax.grad of sum(image²).  Not
    under jit, as tests/test_dist.py takes it: jit fuses the arithmetic
    differently and moves config 3's sphere gradient by 1e-4 of itself."""
    import jax
    import jax.numpy as jnp

    from tpurt.dist import scene_shard as JSH
    from tpurt.kernels import traversal as JTV
    from tpurt.scene import configs as jconfigs

    out = {}
    for name in TPURT_CASES:
        k, h, w, depth, shadows, kw = CASES[name]
        _, _, plan = _case(name)
        js, jcfg = jconfigs.ALL_CONFIGS[k](h, w, **kw)
        jcfg = jcfg.replace(max_depth=depth, shadows=shadows)
        js2, jt2 = JSH.renumber_by_clusters(js, jnp.asarray(plan.tri_ids.numpy()))

        def loss(s, jcfg=jcfg, jt2=jt2, h=h):
            img = JTV.render_rows_clustered(s, jcfg, jt2, 0, h)
            return jnp.sum(img ** 2), img

        (_, img), g = jax.value_and_grad(loss, has_aux=True, allow_int=True)(js2)
        out[name] = (np.asarray(img), g)
    return out


@pytest.mark.parametrize("name", TPURT_CASES)
def test_ring_image_matches_tpurt(ring, tpurt_refs, name):
    img, _ = tpurt_refs[name]
    for r in ring:
        np.testing.assert_allclose(r[name]["image"].numpy(), img, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", TPURT_CASES)
def test_ring_grads_match_tpurt(ring, tpurt_refs, name):
    """tpurt's bar on the light, the spheres and the vertices
    (tests/test_dist.py:171-178); the port's on every other float leaf."""
    _, gj = tpurt_refs[name]
    got = ring[0][name]["grads"]
    for k, b in got.items():
        a = np.asarray(functools.reduce(getattr, k.split("."), gj))
        b = b.numpy()
        assert np.isfinite(b).all(), k
        top = float(np.abs(a).max()) if a.size else 0.0
        if k in TPURT_LEAVES:
            np.testing.assert_allclose(b, a, rtol=TPURT_RTOL,
                                       atol=TPURT_ATOL * max(1.0, top), err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_RTOL * top + 1e-12, err_msg=k)
    assert float(np.abs(got["vertices"].numpy()).max()) > 0.0
