"""Closed-set scene-parsing training (anomaly/train.py).

Same loop as ``train_embedding`` with the plain decoder family
(ppm_deepsup / c1_deepsup / upernet ...) and the CE(+VAR) loss of
SegmentationModule on log-softmax outputs; over N ranks under
``torch.distributed.run`` as ``train_embedding`` is.
"""

from __future__ import annotations

import torch

from ._common import compute_dtype, config_parser, leave_ranks, parse_config
from . import train_embedding


def main(cfg, precision_dtype=torch.bfloat16, max_steps=None, device=None):
    return train_embedding.main(cfg, precision_dtype, max_steps=max_steps,
                                device=device)


def _entry():
    parser = config_parser(__doc__)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many train steps")
    args = parser.parse_args()
    cfg = parse_config(args)
    main(cfg, compute_dtype(args), max_steps=args.max_steps,
         device=args.device)
    leave_ranks()


if __name__ == "__main__":
    _entry()
