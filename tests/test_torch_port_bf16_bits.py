"""bf16 serving keeps its bits now that the compute dtype is the modules'
and not the weights': `set_compute_dtype(bf16)` (compute dtype and weight
cast) gives the same stream bytes and the same images, bit for bit, as a
copy whose every cast and promote layer is the stock torch layer, which
computes in its weights' dtype (the VAE's promoting convolutions, which
took their fp32 inputs up to fp32 before as well, stay). On the CPU, at the
micro config, DDPM and DDIM with guidance."""
import copy
import io

import numpy as np
import pytest
import torch
from torch import nn

from rdeic_torch.inference import process
from rdeic_torch.models import blocks
from rdeic_torch.pipeline.rdeic import RDEIC
from tests.torch_port_helpers import MICRO
from tests.torch_port_tf32 import one_torch_thread  # noqa: F401 (autouse)

STOCK = {blocks.Linear: nn.Linear, blocks.Conv2d: nn.Conv2d,
         blocks.LayerNorm: nn.LayerNorm}


def _models():
    torch.manual_seed(0)
    model = RDEIC(**copy.deepcopy(MICRO), device="cpu").eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for v in model.state_dict().values():
            std = v[0].numel() ** -0.5 if v.dim() > 1 else 0.1
            v.copy_(torch.randn(v.shape, generator=g) * std)
        model.vq_embed_prob.zero_()
    model.set_compute_dtype(torch.bfloat16)
    stock = copy.deepcopy(model)
    swapped = 0
    for m in stock.modules():
        if type(m) in STOCK:
            m.__class__ = STOCK[type(m)]
            swapped += 1
    for m in stock.denoiser.modules():  # the UNet's 1x1 bridges
        if type(m) is blocks.PromotedConv2d:
            m.__class__ = nn.Conv2d
            swapped += 1
    assert swapped > 0
    return model, stock


@pytest.mark.parametrize("sampler,guidance", [("ddpm", 1.0), ("ddim", 2.0)])
def test_bf16_serving_equals_stock_layers_in_the_weights_dtype(tmp_path, sampler,
                                                                guidance):
    model, stock = _models()
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, 64, 128, 3)).astype(np.float32))
    out = {}
    for name, m in (("port", model), ("stock", stock)):
        stream = tmp_path / f"{name}.rdeic"
        rec, _ = process(m, img, 2, str(stream), torch.Generator().manual_seed(5),
                         sampler, guidance)
        out[name] = (stream.read_bytes(), rec)
    assert out["port"][0] == out["stock"][0]
    np.testing.assert_array_equal(out["port"][1], out["stock"][1])
    assert out["port"][1].std() > 0
