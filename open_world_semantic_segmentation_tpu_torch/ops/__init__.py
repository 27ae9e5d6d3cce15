"""Tensor ops of the port: resize, pooling, distance heads, the concat-free
PPM fuse conv and the knn-cosine kernel."""
