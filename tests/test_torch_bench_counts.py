"""The port's ray counts (tpurt_torch.tools.bench.count_rays and
count_rays_traced) on the CPU, where the kernels' plain versions run, against
the repo root's bench.py: both counts equal bench.py's on the same scenes, one
clustered case with live continuations.  The bench command itself is in
tests/test_torch_bench.py."""
import pytest

from tpurt.render import prepare as jprepare
from tpurt.scene import configs as jconfigs
from tpurt_torch.bridge import plan_from_tpurt, scene_from_tpurt
from tpurt_torch.core.types import RenderConfig
from tpurt_torch.scene import configs
from tpurt_torch.tools import bench
from test_api import _import_bench
import torch_one_thread  # noqa: F401  (one PyTorch thread)

# name: (tpurt scene constructor, accel)
TRACED_CASES = {
    "config4": (lambda: jconfigs.config4_bunny(32, 32, subdiv=4), None),   # tests/test_api.py
    "config1": (lambda: jconfigs.config1_sphere(16, 16), None),           # phase-1
    "config3-bvh": (lambda: jconfigs.config3_spheres(16, 16), "bvh"),     # live continuations
}


def _tcfg(jcfg):
    return RenderConfig(width=jcfg.width, height=jcfg.height, max_depth=jcfg.max_depth,
                        shadows=jcfg.shadows, wavefront=jcfg.wavefront)


@pytest.fixture(scope="module")
def traced():
    """bench.py's counts of each case (tpurt's interpret-mode records), and
    the port's scene, config and plan of the same scene and topology."""
    jbench = _import_bench()
    out = {}
    for name, (build, accel) in TRACED_CASES.items():
        js, jcfg = build()
        jplan = jprepare(js, jcfg, accel=accel)
        ts = scene_from_tpurt(js, device="cpu")
        out[name] = (jbench.count_rays(jcfg, js), jbench.count_rays_traced(jcfg, js, jplan),
                     ts, _tcfg(jcfg), plan_from_tpurt(jplan, ts))
    return out


@pytest.mark.parametrize("name", list(TRACED_CASES))
def test_count_rays_traced_equals_bench_py(traced, name):
    nominal, want, ts, tcfg, plan = traced[name]
    got = bench.count_rays_traced(tcfg, ts, plan)
    assert bench.count_rays(tcfg, ts) == nominal
    assert got == want
    n_pix = tcfg.height * tcfg.width
    if plan.kind == "phase1":
        assert got == nominal
    else:
        assert n_pix <= got < nominal


def test_the_traced_count_has_live_continuations(traced):
    """Config 3 on a "bvh" plan: reflective spheres, so rays enter later
    bounces and the live term of the count is not zero."""
    _, _, ts, tcfg, plan = traced["config3-bvh"]
    hits, live = bench.traced_terms(tcfg, ts, plan)
    assert len(hits) == tcfg.max_depth + 1 and sum(live[:-1]) > 0
    assert all(l <= h for h, l in zip(hits, live))


@pytest.mark.parametrize("config,size", [(1, (16, 16)), (2, (12, 20)), (3, (16, 24)),
                                         (4, (8, 8))])
def test_count_rays_equals_bench_py(config, size):
    kw = {"subdiv": 2} if config == 4 else {}
    js, jcfg = jconfigs.ALL_CONFIGS[config](*size, **kw)
    ts, tcfg = configs.ALL_CONFIGS[config](*size, device="cpu", **kw)
    for over in ({}, {"shadows": False}, {"max_depth": 1}):
        assert (bench.count_rays(tcfg.replace(**over), ts)
                == _import_bench().count_rays(jcfg.replace(**over), js))
