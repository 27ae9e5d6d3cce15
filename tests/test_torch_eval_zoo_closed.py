"""The port's ``cli/test_closed`` against the JAX package's on
resnet18dilated + C1: the multi-scale average of softmax probabilities,
its argmax and msp map, and the closed-set and OOD metrics. The method
and tolerances are ``test_torch_eval_zoo.py``'s.
"""

from test_torch_eval import street_tree  # noqa: F401
from test_torch_eval_zoo import check_cli_case


def test_test_closed_c1_matches_jax(street_tree, tmp_path, monkeypatch):
    check_cli_case(street_tree, tmp_path, monkeypatch, "test_closed", "c1",
                   "msp")
