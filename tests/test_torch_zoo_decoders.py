"""The new decoders in the port against the JAX package's: C1 (with the
softmax of ``use_softmax``), C1DeepSup, PPM (with the softmax), UPerNet and
``upernet_lite`` (with the softmax), each on the narrow resnet18dilated
body of ``test_torch_zoo.py``, whose note gives the method and the
tolerances. (C1DeepSup's training outputs, ``deepsup`` included, are held
in ``test_torch_mobilenet.py``'s train step.)
"""

import pytest

from test_torch_zoo import case_ids, check_zoo_case

CASES = [("resnet18dilated", "c1", True),
         ("resnet18dilated", "c1_deepsup", False),
         ("resnet18dilated", "ppm", True),
         ("resnet18dilated", "upernet", False),
         ("resnet18dilated", "upernet_lite", True)]


@pytest.mark.parametrize("encoder,decoder,use_softmax", CASES,
                         ids=case_ids(CASES))
def test_decoder_matches_jax(encoder, decoder, use_softmax):
    check_zoo_case(encoder, decoder, use_softmax,
                   10 + CASES.index((encoder, decoder, use_softmax)))
