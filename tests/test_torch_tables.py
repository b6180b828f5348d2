"""The host-side rule that picks how the phase-1 backward kernels sum their
cotangent tables (tpurt_torch/kernels/megakernel.py:takes_fixed_order), on
the CPU: a pure function of the table's size, the depths kept and the card's
shared memory.  A table too large for the shared-memory route takes the
records route, whose scratch and slabs (records_bytes, slab_pixels) are held
here too.  No kernel runs here; the card tests hold the kernels to it, and
the map from the records' sums to the table, which the kernels' source makes
(record_map), to an index_add_ of each value where it belongs
(tests/test_torch_cuda.py).
"""
import re
from pathlib import Path

import pytest

from tpurt_torch.kernels import megakernel as MK
from tpurt_torch.kernels.pack import pack_scene
from tpurt_torch.scene import configs

import torch_one_thread  # noqa: F401  (one PyTorch thread)

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


def test_large_tables_take_the_records_route():
    # the phase-1 limit: 4096 triangles and 4096 spheres, one light: the
    # records route, whose warps copy only the 21 globals
    n = 15 + 6 + 47 * 4096 + 43 * 4096
    assert not MK.takes_fixed_order(n, 1, *H100)
    assert MK.takes_fixed_order(0, 1, *H100)
    for depths in range(1, MK.MAX_DEPTHS + 1):
        nbytes = MK.phase1_shared_bytes(15 + 6, depths, True)
        assert nbytes <= H100[1] and H100[0] // (nbytes + H100[2]) >= 1


def test_records_scratch_and_slabs():
    # a key and 32 values a pixel and depth: 821 MB at 1080x1920 and 3 depths,
    # under the 1 GiB a launch may take, so one slab
    n_pix = 1080 * 1920
    assert MK.records_bytes(n_pix, 3) == 4 * 33 * 3 * n_pix == 821_145_600
    assert MK.slab_pixels(n_pix, 1920, 3) == n_pix
    # at 16 depths, slabs of 264 rows
    slab = MK.slab_pixels(n_pix, 1920, 16)
    assert slab == 264 * 1920 and slab % 1920 == 0
    assert MK.records_bytes(slab, 16) <= MK.RECORD_SCRATCH_LIMIT
    assert MK.records_bytes(slab + 1920, 16) > MK.RECORD_SCRATCH_LIMIT
    # a row at least, however small the limit
    assert MK.slab_pixels(n_pix, 1920, 3, limit=1000) == 1920
    assert MK.slab_pixels(100, 10, 2, limit=MK.records_bytes(100, 2)) == 100


def test_the_rule_follows_the_card():
    # config 2's table costs an A100 a block an SM: there it takes the atomics
    assert MK.takes_fixed_order(1662, 1, *H100)
    assert not MK.takes_fixed_order(1662, 1, *A100)
    assert MK.fixed_order_limit(1, *A100) < 1662 < MK.fixed_order_limit(1, *H100)


def test_constants_match_the_kernel_sources():
    text = "".join((CSRC / f).read_text() for f in ("megakernel_adjoint.cuh",
                                                     "megakernel_common.cuh",
                                                     "phase1_math.cuh"))

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("THREADS") == MK.THREADS and const("THREADS") // 32 == MK.WARPS
    assert const("MIN_BLOCKS") == MK.MIN_BLOCKS
    assert (const("ROWS"), const("PITCH")) == (MK.SCRATCH_ROWS, MK.SCRATCH_PITCH)
    assert const("MAX_DEPTHS") == MK.MAX_DEPTHS
    assert const("MAX_LIGHTS") == MK.MAX_LIGHTS
    assert re.search(r'sizeof\(Residual\) == (\d+)', text).group(1) == str(4 * MK.RES_WORDS)
    assert re.search(r"\bR_ALL = (\d+);", text).group(1) == str(MK.RECORD_FLOATS)
