#!/usr/bin/env python3
"""The JAX package's bf16 forward against its fp32 one on the weights that
``deeplab_bf16_drift.py`` measures the port on, on the CPU (not a test:
pytest does not collect it).

    python tests/jax_bf16_drift.py --size 256 512

Builds ``chip_smoke.py``'s synthetic Cityscapes tree and data-started
checkpoint of deeplabv3plus_embedding_resnet101 on the CPU, carries the
checkpoint into the JAX package through its own converter
(``train/convert.py convert_deeplab_checkpoint``), and runs the first val
image through ``models/deeplab.py deeplabv3plus_embedding_resnet101`` with
``dtype`` float32 and bfloat16, and through the port in fp32 and under
bf16 autocast. Prints, for the logits and the features, each pair's
largest |difference| over the largest |reference|, root-mean-square
difference over the reference's, and argmax agreement: the JAX package in
bf16 against itself in fp32, the port likewise, the port in fp32 against
the JAX package in fp32. Keep the size small: full width runs here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from chip_smoke import distance  # noqa: E402
from open_world_semantic_segmentation_tpu.models import (  # noqa: E402
    deeplab as jdeeplab)
from open_world_semantic_segmentation_tpu.train.convert import (  # noqa: E402
    convert_deeplab_checkpoint)
from open_world_semantic_segmentation_tpu_torch.cli.main_deeplab import (  # noqa: E402,E501
    build_deeplab_model, get_transforms, get_val_dataset,
    init_or_load_deeplab)
from open_world_semantic_segmentation_tpu_torch.core.config import (  # noqa: E402,E501
    load_config)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, nargs=2, default=[256, 512])
    args = p.parse_args(argv)
    chip_smoke.DEVICE = "cpu"
    os.chdir(REPO)
    with tempfile.TemporaryDirectory() as root:
        tree = os.path.join(root, "cityscapes")
        chip_smoke.write_cityscapes_tree(
            tree, {"train": chip_smoke.N_SUPPORT_IMAGES,
                   "val": chip_smoke.N_VAL_IMAGES}, tuple(args.size),
            chip_smoke.SEED + 2)
        cfg = load_config("configs/cityscapes_embedding.yaml",
                          ["DATASET.root_dataset", tree])
        path = chip_smoke.write_deeplab_checkpoint(
            cfg, os.path.join(root, "deeplab_embedding.pth"),
            chip_smoke.SEED)
        state = torch.load(path, map_location="cpu")["model_state"]
        ds = get_val_dataset(cfg, get_transforms(cfg.DEEPLAB.crop_size)[1])
        x = ds[0][0][None]

        variables = convert_deeplab_checkpoint(
            {"model_state": {k: v.numpy() for k, v in state.items()}})
        outs = {}
        for name, dtype in (("jax_fp32", jnp.float32),
                            ("jax_bf16", jnp.bfloat16)):
            model = jdeeplab.deeplabv3plus_embedding_resnet101(dtype=dtype)
            out = jax.jit(model.apply)(variables, jnp.asarray(x))
            outs[name] = [torch.from_numpy(np.array(out[i], np.float32))
                          for i in (0, 2)]
        model, _ = build_deeplab_model(cfg, "cpu")
        init_or_load_deeplab(model, path)
        with torch.no_grad():
            out = model(torch.from_numpy(x))
            outs["port_fp32"] = [out[0], out[2]]
            with torch.autocast("cpu", dtype=torch.bfloat16):
                out = model(torch.from_numpy(x))
            outs["port_bf16"] = [out[0].float(), out[2].float()]
    for got, want in (("jax_bf16", "jax_fp32"), ("port_bf16", "port_fp32"),
                      ("port_fp32", "jax_fp32"), ("port_bf16", "jax_bf16")):
        print(json.dumps({
            "pair": f"{got} vs {want}", "size": args.size,
            "logits": distance(outs[got][0], outs[want][0]),
            "features": distance(outs[got][1], outs[want][1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
