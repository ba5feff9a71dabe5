"""Finds the benchmark's parts by the names ``BENCHMARK.json`` gives them.

* a cell: its entry in ``BENCHMARK.json``'s ``workloads``;
* a configuration: ``configs/<name>.json``; its ``model`` names the modules
  ``systems/<model>.py``, ``reference/<model>.py`` and ``work/<model>.py``;
* a traffic mix: ``traffic/<name>.json``;
* a cell's limits for the numbers that decide ``correct``:
  ``cells/<cell>.json``;
* a metric's reader: ``metrics/<name>.py``, with ``read(ctx)``;
* a device's peaks: ``peaks/<device name, spaces as _>.json``.

``root`` is the ``portbench`` directory (default: this one); the checkout is
its parent.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re

ROOT = pathlib.Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_MODEL = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _root(root) -> pathlib.Path:
    return ROOT if root is None else pathlib.Path(root)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(root, kind: str, name: str, ext: str) -> pathlib.Path:
    if not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = _root(root) / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def benchmark(root=None) -> dict:
    return _json(_root(root).parent / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, root=None) -> dict:
    return _json(_named(root, "configs", name, ".json"))


def traffic(name: str, root=None) -> dict:
    return _json(_named(root, "traffic", name, ".json"))


def limits(cell: str, root=None) -> dict:
    return _json(_named(root, "cells", cell, ".json"))


def peaks(device_kind: str, root=None) -> dict | None:
    path = _root(root) / "peaks" / (device_kind.replace(" ", "_") + ".json")
    return _json(path) if path.is_file() else None


def model_module(kind: str, model: str):
    """``portbench.<kind>.<model>`` (kind: systems, reference, work)."""
    if not _MODEL.match(model):
        raise ValueError(f"bad model name {model!r}")
    return importlib.import_module(f"portbench.{kind}.{model}")


def reader(name: str, root=None):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = _named(root, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` lists,
    else every cell that reports the end-to-end metric it ``moves`` (or, for
    an end-to-end metric without ``workloads``, every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    for m in bench["end_to_end"]:
        if m["name"] == moves:
            return applies(m, cell, bench)
    return False
