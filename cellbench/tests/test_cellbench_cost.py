"""The frozen operation count is ``FlopCounterMode``'s, and the program's."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cellbench import harness
from cellbench.cost import forward_cost
from cellbench.reference.unet import UNet


@pytest.mark.parametrize("channels,patch,batch", [((4, 8, 16, 32), 16, 2),
                                                  ((16, 32, 64, 128), 16, 1),
                                                  ((8, 16, 32, 64), (16, 24, 32), 3)])
def test_flops_equal_flop_counter(channels, patch, batch):
    model = dict(harness.load_json("configs", "unet_fl70")["config"]["model"],
                 encoder_channels=list(channels))
    net = UNet(model).eval()
    dims = (patch,) * 3 if isinstance(patch, int) else patch
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(batch, 1, *dims))
    assert forward_cost(model, batch, patch)[0] == counter.get_total_flops()


def test_equal_to_the_programs_count():
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.models.cost import forward_cost as program_cost

    settings = harness.load_json("configs", "unet_fl70")["config"]
    cfg = Config.from_dict(settings)
    n = sum(p.numel() for p in UNet(settings["model"]).parameters())
    assert n == 217228
    assert forward_cost(settings["model"], 96, 48, 2, n) == program_cost(cfg.model, 96, 48)
