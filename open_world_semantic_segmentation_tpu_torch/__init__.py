"""PyTorch/CUDA port of the open-world semantic segmentation system.

Mirrors the layout of the JAX package ``open_world_semantic_segmentation_tpu``
module for module; public functions keep its layouts (NHWC images,
``(H, W, K)`` score maps) so each module can be held against its JAX
counterpart on the same inputs. The port imports neither JAX nor the JAX
package.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); without a GPU they raise instead of
falling back. Hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``ops/_build.py``).
"""

__version__ = "0.1.0"   # the JAX package's: artifacts stamp it
