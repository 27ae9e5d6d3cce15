#!/usr/bin/env python3
"""Split the knn_cosine CUDA kernel's time by phase, on one CUDA GPU.

    python3 knn_phases.py

Builds ``csrc/knn_cosine.cu`` as it is and three cut-down copies of it
(into ``build/knn_phases/``), each with a later part of the kernel left
out, and times every build's raw launch at the eval shape (720x1280x13,
neighbor_size 9) in bf16 and float32, as 20 launches replayed from a CUDA
graph (so the host's launch cost is not counted), twice, alternating:

- ``full``: the kernel as it is (also checked against the plain version);
- ``no_channels``: staging and norms, without the per-channel passes;
- ``staging``: staging only;
- ``empty``: neither staging, norms nor passes: the launch, the grid and
  the output stores.

Differences between neighbouring builds give each phase's share. A cut
copy computes garbage; only ``full`` is checked. Prints one JSON object
per line, the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import cuda_time_ms, gpu_name_and_power  # noqa: E402
from open_world_semantic_segmentation_tpu_torch.ops import _build  # noqa: E402
from open_world_semantic_segmentation_tpu_torch.ops.knn import (  # noqa: E402
    knn_cosine_plain)

SOURCE = _build.CSRC / "knn_cosine.cu"
OUT = Path(__file__).resolve().parent / "build" / "knn_phases"
CHANNELS = ("for (int c = 0; c < C; ++c) {\n      float* sc",
            "for (int c = 0; c < 0; ++c) {\n      float* sc")
NORMS = ("    for (int i = tid; i < L::kR * L::kQ; i += kThreads) {",
         "    for (int i = tid; i < 0; i += kThreads) {")
STAGING = ("    // 1. stage the window:", "    if (false)  // 1. stage the window:")
CUTS = {"full": (), "no_channels": (CHANNELS,), "staging": (CHANNELS, NORMS),
        "empty": (CHANNELS, NORMS, STAGING)}


def build(name):
    src = SOURCE.read_text()
    for old, new in CUTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: cannot find {old!r} in {SOURCE}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
           str(OUT / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    lib.knn_cosine.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.knn_cosine.restype = ctypes.c_int
    return name, lib


def main():
    if not torch.cuda.is_available():
        print("knn_phases: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"gpu": gpu_name_and_power()}), flush=True)
    with ThreadPoolExecutor(len(CUTS)) as pool:
        libs = dict(pool.map(build, CUTS))
    h, w, c, halo = 720, 1280, 13, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = torch.empty((h, w), device="cuda")
    inputs = {name: torch.randn((h, w, c), generator=gen,
                                device="cuda").to(dtype)
              for name, dtype in (("bfloat16", torch.bfloat16),
                                  ("float32", torch.float32))}
    times = {}
    for _ in range(2):
        for name, lib in libs.items():
            for dname, ft in inputs.items():
                def launch(lib=lib, ft=ft):
                    err = lib.knn_cosine(
                        ft.data_ptr(), ft.element_size(), out.data_ptr(), h,
                        w, c, halo, 1e-8,
                        torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                if name == "full":
                    err = (out - knn_cosine_plain(ft)).abs().max().item()
                    if not err <= 2e-5:
                        raise AssertionError(f"full {dname}: {err}")
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(20):
                        launch()
                times.setdefault((name, dname), []).append(
                    cuda_time_ms(graph.replay, iters=5) / 20)
    for (name, dname), ms in times.items():
        print(json.dumps({"build": name, "dtype": dname, "ms": ms,
                          "shape": [h, w, c]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
