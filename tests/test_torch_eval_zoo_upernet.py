"""The port's ``cli/eval_ood`` against the JAX package's on
resnet18dilated + ``upernet_lite``, scored by the max of the averaged
softmax probabilities (``maxlogit`` over a softmax decoder). The method
and tolerances are ``test_torch_eval_zoo.py``'s.
"""

from test_torch_eval import street_tree  # noqa: F401
from test_torch_eval_zoo import check_cli_case


def test_eval_ood_upernet_lite_matches_jax(street_tree, tmp_path,
                                           monkeypatch):
    check_cli_case(street_tree, tmp_path, monkeypatch, "eval_ood",
                   "upernet_lite", "maxlogit")
