"""The port's pyramid artifact (``core/export.py``) against the JAX
package and the port's direct forward.

The twin and weights of ``test_torch_export.py``, float32 on the CPU at
32x48. The pyramid artifact, at the two shapes ``cli/export_model.py
--pyramid`` makes of ``DATASET.imgSizes (24, 32)`` (``test_torch_artifacts.py``
checks that), goes through a save and load round trip and is held to the
direct forward and to the JAX pyramid artifact of the same weights.

Tolerances: labels equal on >= 99 % of pixels; float16 conf maps within
2e-3 (NaN where the other's is NaN).
"""

import torch

from open_world_semantic_segmentation_tpu_torch.core import export
from open_world_semantic_segmentation_tpu_torch.openset.evaluator import (
    multi_scale_forward)
# variables and model: test_torch_export.py's module fixtures
from test_torch_export import (SIZE, _roundtrip,
                               check_against_direct_and_jax, model,
                               variables)

PYRAMID = [(24, 40), (32, 48)]


def test_pyramid_artifact_matches_direct_forward_and_jax(tmp_path, model,
                                                         variables):
    blob = export.export_pyramid_eval_fn(model, PYRAMID, SIZE, batch=2)
    fn, _, _ = _roundtrip(tmp_path, blob, {"pyramid": True})
    pred, pyramid = check_against_direct_and_jax(tmp_path, fn, model,
                                                 variables, PYRAMID)
    # the export sums the levels and divides once; the evaluator divides
    # each level: the same labels up to rounding
    with torch.no_grad():
        scores, _ = multi_scale_forward(
            model, [torch.from_numpy(x) for x in pyramid], SIZE)
    assert (scores.argmax(-1).numpy() == pred).mean() >= 0.99
