"""bf16 training of the refine phase, rdeic_torch against rdeic_tpu on the
CPU at the micro config: one refine micro-step with `set_compute_dtype(bf16)`
and `Trainer(frozen_dtype=bf16)` on both sides (the gradient through both
sampler steps of the bf16 dual UNet, the bf16 VAE decoder and LPIPS, whose
bf16-stored weights compute in fp32 on the fp32 images), at the limits
stated in test_torch_port_train_bf16.py."""
import pytest
import torch

from tests.test_torch_port_refine import _img, jax_refine_noise, refine_pair
from tests.test_torch_port_train_bf16 import BF16, bf16_step, check_bf16_step
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore:LPIPS.*RANDOM-INIT")


@pytest.fixture(scope="module")
def refine_run():
    jm, params, tm, _ = refine_pair(seed=0)
    return bf16_step(jm, params, tm, _img(4), jax_refine_noise)


def test_bf16_refine_step_matches_jax(refine_run):
    reads = check_bf16_step(refine_run)
    assert {"l_mse", "l_lpips"} <= set(reads)


def test_bf16_refine_keeps_lpips_bf16_and_computing_in_fp32(refine_run):
    """LPIPS's weights are frozen, stored in bf16, and unmoved; its layers
    promote (no compute dtype), so on fp32 images it computes in fp32; the
    VAE decoder's output (its conv_out promotes an fp32 input) is fp32."""
    tm = refine_run["tm"]
    lp = tm.lpips
    assert all(p.dtype == BF16 and not p.requires_grad for p in lp.parameters())
    x = torch.rand(1, 64, 64, 3) * 2 - 1
    with torch.no_grad():
        assert lp(x, x * 0.5).dtype == torch.float32
        assert lp.backbone.conv1(x.permute(0, 3, 1, 2)).dtype == torch.float32
        z = torch.randn(1, 8, 8, 4)
        assert tm.decode_first_stage(z).dtype == torch.float32
