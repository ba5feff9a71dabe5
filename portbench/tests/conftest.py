"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark
with its configurations cut to a size a CPU runs in a second."""
import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: level-0 extents of the tiny copies, by configuration
TINY = {"adv_uniform_512": [16, 16, 8], "adv_amr_48": [8, 8, 8],
        "adv_amr_128": [12, 12, 12]}


def tiny_tree(dest: pathlib.Path) -> pathlib.Path:
    """``dest/portbench`` (data, readers, cells) and ``dest/BENCHMARK.json``
    as in the repo, with each configuration cut to ``TINY``; returns the
    ``portbench`` copy."""
    root = dest / "portbench"
    shutil.copytree(REPO / "portbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, n in TINY.items():
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["initial_length"] = n
        path.write_text(json.dumps(cfg))
    return root


@pytest.fixture
def tiny(tmp_path):
    return tiny_tree(tmp_path)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return "cuda"
