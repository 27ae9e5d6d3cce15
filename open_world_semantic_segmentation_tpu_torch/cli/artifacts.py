"""Artifact zoo tooling: list and validate directories of ``.owss`` exports.

The port's counterpart of the JAX package's ``cli/artifacts.py``, for the
``torch.export`` artifacts of ``cli/export_model.py``. Two subcommands:

- ``list DIR``: header-only scan (``core.export.read_meta``); prints one
  JSON line per artifact (path, size and the stamped metadata:
  format/owss_version/torch_version/model/input/quant/...). Never reads
  the payload.
- ``check PATH [PATH...]``: validates the metadata schema for the
  artifact's kind (plain / pyramid / NPM, the three that
  ``cli/export_model.py`` writes), flags an artifact whose device this
  machine lacks, and otherwise loads the program and prints its calling
  convention and the device it runs on. With ``--run`` it also runs the
  artifact on zeros at its declared input spec and checks that the
  outputs are finite.

Usage:
    python -m open_world_semantic_segmentation_tpu_torch.cli.artifacts list zoo/
    python -m open_world_semantic_segmentation_tpu_torch.cli.artifacts check zoo/m.owss --run
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import torch


def list_artifacts(root: str) -> list:
    """Header-scan ``root`` (a directory or a single file) -> list of
    manifest rows. Non-artifact files are skipped; unreadable artifacts
    become rows with an ``error`` field."""
    from ..core.export import read_meta

    if os.path.isdir(root):
        paths = sorted(glob.glob(os.path.join(root, "**", "*.owss"),
                                 recursive=True))
    else:
        paths = [root]
    rows = []
    for p in paths:
        row = {"path": p, "bytes": os.path.getsize(p)}
        try:
            row.update(read_meta(p))
        except (ValueError, json.JSONDecodeError) as e:
            row["error"] = str(e)
        rows.append(row)
    return rows


def _kind(meta: dict) -> str:
    if meta.get("npm"):
        return "npm"
    if meta.get("pyramid"):
        return "pyramid"
    return "plain"


def validate_meta(meta: dict) -> list:
    """Schema problems for the three artifact kinds export_model writes."""
    problems = []
    if meta.get("format") != 1:
        problems.append(f"unknown format {meta.get('format')!r}")
    for key in ("owss_version", "torch_version", "model", "input",
                "platforms"):
        if key not in meta:
            problems.append(f"missing meta key {key!r}")
    kind = _kind(meta)
    if kind == "npm":
        for key in ("prototype_dim", "novel_id", "dis_threshold"):
            if key not in meta:
                problems.append(f"npm artifact missing {key!r}")
    elif "method" not in meta:
        problems.append("missing meta key 'method'")
    if kind == "pyramid" and not (
            isinstance(meta.get("input"), list) and meta["input"]
            and isinstance(meta["input"][0], list)):
        problems.append("pyramid 'input' must be a list of shapes")
    return problems


def _run_on_zeros(program, meta: dict, device: str) -> list:
    """Run on zeros at the declared input spec; non-finite or raising
    outputs are problems."""
    spec, kind = meta.get("input"), _kind(meta)
    try:
        shapes = spec if kind == "pyramid" else [spec]
        args = [torch.zeros(s, device=device) for s in shapes]
        if kind == "npm":
            args.append(torch.zeros((meta["prototype_dim"],), device=device))
        with torch.inference_mode():
            out = program.module().to(device)(*args)
    except Exception as e:
        return [f"execution failed: {type(e).__name__}: {e}"]
    for leaf in out if isinstance(out, (tuple, list)) else [out]:
        if not bool(torch.isfinite(leaf.float()).all()):
            return ["non-finite output on zero input"]
    return []


def _avals(nodes) -> list:
    """'dtype[shape]' of each traced value, as the JAX avals print."""
    out = []
    for node in nodes:
        val = node.meta.get("val")
        if isinstance(val, torch.Tensor):
            out.append(f"{str(val.dtype).split('.')[-1]}{list(val.shape)}")
    return out


def check_artifact(path: str, run: bool = False) -> dict:
    """Validate the metadata schema of ``path``; where this machine has
    its device, load the program and report its calling convention, and
    with ``run=True`` run it on zero inputs."""
    from ..core.export import read_meta, read_program

    meta = read_meta(path)
    platforms = meta.get("platforms") or []
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    here = [p for p in platforms if p in devices]
    problems = validate_meta(meta)
    report = {
        "path": path,
        "meta": meta,
        "in_avals": None,
        "out_avals": None,
        "platforms": list(platforms),
        "current_backend": devices[-1],
        "runs_here": bool(here),
    }
    if here:
        # the program's tensors load onto the device they were saved from
        program, _ = read_program(path)
        user_inputs = set(program.graph_signature.user_inputs)
        nodes = list(program.graph.nodes)
        outs = next(n for n in nodes if n.op == "output").args[0]
        report["in_avals"] = _avals(
            n for n in nodes
            if n.op == "placeholder" and n.name in user_inputs)
        report["out_avals"] = _avals(
            outs if isinstance(outs, (tuple, list)) else [outs])
        if run and not problems:
            problems += _run_on_zeros(program, meta, here[0])
            report["ran_on_zeros"] = not problems
    report["problems"] = problems
    report["valid"] = not problems
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="owss-artifacts", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_list = sub.add_parser("list", help="header-only manifest scan")
    p_list.add_argument("root", help=".owss file or directory (recursive)")
    p_check = sub.add_parser("check", help="load + verify")
    p_check.add_argument("paths", nargs="+",
                         help=".owss files and/or directories (recursive)")
    p_check.add_argument("--run", action="store_true",
                         help="also run each artifact on zero inputs "
                              "and verify finite outputs")
    args = parser.parse_args(argv)

    rc = 0
    if args.cmd == "list":
        for row in list_artifacts(args.root):
            print(json.dumps(row))
            if "error" in row:
                rc = 1
    else:
        paths = []
        for p in args.paths:
            paths += [r["path"] for r in list_artifacts(p)] \
                if os.path.isdir(p) else [p]
        for p in paths:
            try:
                report = check_artifact(p, run=args.run)
            except Exception as e:  # loud per-file failure, keep going
                print(json.dumps({"path": p, "error": str(e)}))
                rc = 1
                continue
            print(json.dumps(report))
            if not report["runs_here"] or not report["valid"]:
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
