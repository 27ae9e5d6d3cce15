"""Tensor ops of the port: resize, pooling, distance heads, the concat-free
PPM fuse conv, the knn-cosine kernel and the int8 PTQ (``quant.py``)."""
