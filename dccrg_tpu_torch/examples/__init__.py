"""User examples on the port: one module for each of the JAX package's
``examples/`` scripts, with the same name, arguments and printed lines.

    python -m dccrg_tpu_torch.examples.simple_game_of_life [--device cpu|cuda]

Each runs on CUDA unless ``--device cpu`` is given, and exits non-zero
when its check fails.  Where the JAX example runs with x64 off (all but
``ensemble_serving``), its float64 model default is float32 there, so the
port names ``np.float32`` explicitly; ``ensemble_serving`` enables x64 and
names ``np.float64``.
"""
import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser with the port's ``--device``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the example runs (default: cuda)")
    return ap

