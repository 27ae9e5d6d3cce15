#!/usr/bin/env python3
"""Where the bf16 fused bottleneck kernel spends its time, by phase.

    python3 fused_block_phases.py

No profiler traces the card on the machine the port is measured on, so
this attributes the kernel's time by removal: ``csrc/fused_bottleneck.cu``
is built six times, with phases compiled out by its FUSED_BLOCK_SKIP_*
switches, and each build is timed with CUDA events at the seven block
geometries of ``chip_smoke.py`` (resnet50dilated at the largest pyramid
level, one image, bf16). The outputs of the cut builds are meaningless;
only their times are read:

    conv3   = full - no_conv3
    conv2   = no_conv3 - conv1_phase
    conv1   = conv1_phase (its copies, its products, and the rest: launch,
              accumulator set-up, y1 epilogue) split by the last three
              builds, whose sum exceeds conv1_phase by what overlaps.

Prints one JSON line per geometry and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

VARIANTS = {
    "full": (),
    "no_conv3": ("CONV3",),
    "conv1_phase": ("CONV2", "CONV3"),
    "conv1_copies": ("CONV2", "CONV3", "CONV1_MMA"),
    "conv1_mma": ("CONV2", "CONV3", "CONV1_COPIES"),
    "conv1_rest": ("CONV2", "CONV3", "CONV1_MMA", "CONV1_COPIES"),
}


def build(name):
    from open_world_semantic_segmentation_tpu_torch.ops import _build

    out = _build.BUILD_DIR / f"fused_bottleneck-phases-{name}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    defines = [f"-DFUSED_BLOCK_SKIP_{v}" for v in VARIANTS[name]]
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-o",
                    str(out), str(_build.CSRC / "fused_bottleneck.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.fused_bottleneck.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return name, lib


def main():
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("fused_block_phases: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.gpu_name_and_power(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for block, h, w, cin, cmid, cout, d, down, _ in \
            chip_smoke.BLOCK_GEOMETRIES:
        x, ws = chip_smoke._block_inputs(gen, 1, h, w, cin, cmid, cout, down,
                                         torch.bfloat16)
        out = torch.empty((1, h, w, cout), dtype=x.dtype, device="cuda")
        ptrs = [None if t is None else t.data_ptr() for t in (x, *ws, out)]
        ms = {}
        for name, lib in libs.items():
            def run(lib=lib):
                if lib.fused_bottleneck(1, *ptrs, 1, h, w, cin, cmid, cout,
                                        d, stream) != 0:
                    raise RuntimeError(f"{name}: launch failed")
            ms[name] = chip_smoke.cuda_time_ms(run)
        ms["conv3"] = ms["full"] - ms["no_conv3"]
        ms["conv2"] = ms["no_conv3"] - ms["conv1_phase"]
        print(json.dumps({"block": block, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
