"""The host-side rule that picks how the phase-1 backward kernels sum their
cotangent tables (tpurt_torch/kernels/megakernel.py:takes_fixed_order), on
the CPU: a pure function of the table's size, the depths kept and the card's
shared memory.  No kernel runs here; the card tests hold the kernels to it
(tests/test_torch_cuda.py).
"""
import re
from pathlib import Path

import pytest

from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs

#: an H100's shared memory (cudaDeviceGetAttribute): bytes an SM, the most a
#: block may ask for, bytes an SM keeps back for each block
H100 = (233_472, 232_448, 1_024)
#: an A100's
A100 = (167_936, 166_912, 1_024)
CSRC = Path(MK.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("name,n_want", [(1, 111), (2, 1662), (3, 250), ("smooth", 634)])
def test_configs_take_the_fixed_order_path(name, n_want):
    build = configs.smooth_box if name == "smooth" else configs.ALL_CONFIGS[name]
    scene, cfg = build(8, 8, device="cpu")
    n, depths = MK.table_floats(pack_scene(scene)), cfg.max_depth + 1
    assert n == n_want
    assert MK.takes_fixed_order(n, depths, *H100)
    nbytes = MK.phase1_shared_bytes(n, depths, True)
    assert nbytes <= H100[1] and H100[0] // (nbytes + H100[2]) >= MK.MIN_BLOCKS


def test_shared_bytes_of_a_block():
    # scratch: 8 warps x 16 rows x 36 floats; residuals and bits: 12 words a
    # thread and depth; copies: 8 a table
    assert MK.phase1_shared_bytes(0, 0, False) == 18_432
    assert MK.phase1_shared_bytes(0, 1, False) - 18_432 == 12_288
    assert MK.phase1_shared_bytes(250, 3, True) == 18_432 + 3 * 12_288 + 8 * 250 * 4 == 63_296
    assert MK.phase1_shared_bytes(250, 3, False) == 55_296
    assert MK.phase1_shared_bytes(1662, 1, True) == 83_904


@pytest.mark.parametrize("depths", range(1, MK.MAX_DEPTHS + 1))
def test_the_limit_is_the_boundary(depths):
    largest = MK.fixed_order_limit(depths, *H100)
    assert MK.takes_fixed_order(largest, depths, *H100)
    assert not MK.takes_fixed_order(largest + 1, depths, *H100)
    assert not any(MK.takes_fixed_order(n, depths, *H100) for n in (largest + 2, 10 ** 6))
    # the device path always fits: every depth a backward kernel keeps
    assert MK.phase1_shared_bytes(0, depths, False) <= H100[1]


def test_limits_at_the_depths_the_configs_use():
    # 2 blocks an SM: (233,472 / 2 - 1,024 - 18,432 - 12,288 depths) / 32
    assert MK.fixed_order_limit(1, *H100) == 2_656
    assert MK.fixed_order_limit(3, *H100) == 1_888
    # 8 depths or more: the residuals alone leave one block an SM, and the
    # copies may take the rest of it
    assert MK.fixed_order_limit(8, *H100) == 3_616
    assert MK.fixed_order_limit(16, *H100) == 544


def test_large_tables_take_device_atomics():
    # the phase-1 limit: 4096 triangles and 4096 spheres, one light
    n = 15 + 6 + 47 * 4096 + 43 * 4096
    assert not MK.takes_fixed_order(n, 1, *H100)
    assert MK.takes_fixed_order(0, 1, *H100)


def test_the_rule_follows_the_card():
    # config 2's table costs an A100 a block an SM: there it takes the atomics
    assert MK.takes_fixed_order(1662, 1, *H100)
    assert not MK.takes_fixed_order(1662, 1, *A100)
    assert MK.fixed_order_limit(1, *A100) < 1662 < MK.fixed_order_limit(1, *H100)


def test_constants_match_the_kernel_sources():
    text = "".join((CSRC / f).read_text() for f in ("megakernel_adjoint.cuh",
                                                     "megakernel_common.cuh"))

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("THREADS") == MK.THREADS and const("THREADS") // 32 == MK.WARPS
    assert const("MIN_BLOCKS") == MK.MIN_BLOCKS
    assert (const("ROWS"), const("PITCH")) == (MK.SCRATCH_ROWS, MK.SCRATCH_PITCH)
    assert const("MAX_DEPTHS") == MK.MAX_DEPTHS
    assert re.search(r'sizeof\(Residual\) == (\d+)', text).group(1) == str(4 * MK.RES_WORDS)
