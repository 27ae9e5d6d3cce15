"""HRNetV2 in the port against the JAX package's: a narrow HRNetV2 (stages
of (8, 16), (8, 16, 32), (8, 16, 32, 64) channels, one module each, the
full 64/256 stem and layer1) under the C1 decoder, as ``test_torch_zoo.py``
holds the other encoders (its note gives the method and the tolerances);
then with ``fused_blocks=True``, whose four layer1 bottlenecks take the
fused route (on the CPU, its plain version).
"""

import numpy as np
import torch

from test_torch_zoo import check_zoo_case
from open_world_semantic_segmentation_tpu_torch.models.hrnet import HRNetV2
from open_world_semantic_segmentation_tpu_torch.models.resnet import (
    Bottleneck)
from test_torch_zoo import HRNET, SIZE


def test_hrnetv2_matches_jax():
    port = check_zoo_case("hrnetv2", "c1", False, 30)
    fused = HRNetV2(**HRNET, fused_blocks=True).eval()
    fused.load_state_dict(port.encoder.state_dict())
    routed = [name for name, m in fused.named_modules()
              if isinstance(m, Bottleneck) and m.fused_tile is not None]
    assert routed == [f"layer1.{b}" for b in range(4)]
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (1, 3, *SIZE)).astype(np.float32))
    with torch.no_grad():
        want = port.encoder(x)[0]
        got = fused(x)[0]
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)
