"""Label-map colorization palettes and encoder: a numpy copy of the JAX
package's ``utils/colors.py`` (the port imports nothing of that package).

``STREETHAZARDS_COLORS`` is the CARLA/StreetHazards palette
(eval_ood_traditional.py:35-50); ``CITYSCAPES_TRAIN_COLORS`` is the standard
19-class Cityscapes train-id palette plus black for ignore
(datasets/cityscapes.py:27-67). ``color_encode`` mirrors
anomaly/utils.py:105-125.
"""

from __future__ import annotations

import numpy as np

# StreetHazards class palette; index 13 is the anomalous-object class.
STREETHAZARDS_COLORS = np.uint8([
    [0, 191, 255],    # unlabeled    = 0
    [70, 70, 70],     # building     = 1
    [190, 153, 153],  # fence        = 2
    [250, 170, 160],  # other        = 3
    [220, 20, 60],    # pedestrian   = 4
    [153, 153, 153],  # pole         = 5
    [157, 234, 50],   # road line    = 6
    [128, 64, 128],   # road         = 7
    [244, 35, 232],   # sidewalk     = 8
    [107, 142, 35],   # vegetation   = 9
    [0, 0, 142],      # car          = 10
    [102, 102, 156],  # wall         = 11
    [220, 220, 0],    # traffic sign = 12
    [60, 250, 240],   # anomaly      = 13
])

# Cityscapes 19 train-id colors + black for ignore (train id 19/255).
CITYSCAPES_TRAIN_COLORS = np.uint8([
    [128, 64, 128],   # road
    [244, 35, 232],   # sidewalk
    [70, 70, 70],     # building
    [102, 102, 156],  # wall
    [190, 153, 153],  # fence
    [153, 153, 153],  # pole
    [250, 170, 30],   # traffic light
    [220, 220, 0],    # traffic sign
    [107, 142, 35],   # vegetation
    [152, 251, 152],  # terrain
    [70, 130, 180],   # sky
    [220, 20, 60],    # person
    [255, 0, 0],      # rider
    [0, 0, 142],      # car
    [0, 0, 70],       # truck
    [0, 60, 100],     # bus
    [0, 80, 100],     # train
    [0, 0, 230],      # motorcycle
    [119, 11, 32],    # bicycle
    [0, 0, 0],        # ignore
])


def color_encode(labelmap, colors=STREETHAZARDS_COLORS, mode="RGB"):
    """Map an integer label image to an RGB visualization.

    Negative labels render black. Parity: anomaly/utils.py:105-125.
    """
    labelmap = np.asarray(labelmap).astype(np.int64)
    labelmap_rgb = np.zeros((labelmap.shape[0], labelmap.shape[1], 3),
                            dtype=np.uint8)
    for label in np.unique(labelmap):
        if label < 0:
            continue
        labelmap_rgb += (labelmap == label)[:, :, np.newaxis] * np.tile(
            np.uint8(colors[label % len(colors)]),
            (labelmap.shape[0], labelmap.shape[1], 1))

    if mode == "BGR":
        return labelmap_rgb[:, :, ::-1]
    return labelmap_rgb
