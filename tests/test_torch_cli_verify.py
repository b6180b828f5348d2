"""The port's verification tier (python3 -m tpurt_torch.tools.verify) on the
CPU, where the kernels' plain versions run: two of the tier's cases pass
against the oracle, and its equality cases are exact."""
import numpy as np
import pytest

from tpurt_torch.tools import verify
import torch_one_thread  # noqa: F401  (one PyTorch thread)


@pytest.mark.parametrize("name", ["c1-phase1", "c4-grid"])
def test_verify_case_passes_on_the_cpu(name):
    result = verify.render_grad_case(name, device="cpu")
    assert result["ok"] and result["grads_ok"], result
    assert result["plan"] == ("phase1" if name == "c1-phase1" else "clusters")
    assert np.isfinite(result["mean_diff"]) and result["frac_bad_px"] < verify.BAD_SHARE


@pytest.mark.parametrize("name", list(verify.EQUALITY_CASES))
def test_verify_equality_case_is_exact_on_the_cpu(name):
    """The wavefront loop continues each ray in the kernel's arithmetic, so
    its records equal the multi-bounce launch's, and the re-binned shadows
    the in-kernel ones (config 3 at 64x64 had one id off before)."""
    assert verify.EQUALITY_CASES[name]("cpu") == 0
