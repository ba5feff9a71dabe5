"""Command-line tools of the port, named after the JAX package's
``tools/`` scripts (``tools/<name>.py`` is ``dccrg_tpu_torch/tools/<name>.py``
here) and run as modules:

* ``python -m dccrg_tpu_torch.tools.check_telemetry`` — the telemetry gate:
  the refined-ball advection workload and every observability probe,
  exit 1 on any failure (:mod:`.check_telemetry`);
* ``python -m dccrg_tpu_torch.tools.trace_report`` — the device-timeline
  probe and report (:mod:`.trace_report`);
* ``python -m dccrg_tpu_torch.tools.slo_report`` / ``cost_report`` /
  ``fleet_top`` / ``telemetry_diff`` — the offline consoles over exported
  telemetry files.

Each runs on the card unless ``--device cpu`` is given (the consoles touch
no device).  Their default output goes under ``_telemetry/`` at the
checkout's root, never to the root ``telemetry.json`` or ``tools/``, which
hold the JAX gate's files.  Nothing here runs when the package is
imported.
"""
import pathlib

#: where the tools' default files go (``.gitignore`` lists it)
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / "_telemetry"

#: the gate's default ``--out`` and the consoles' default source
DEFAULT_TELEMETRY = DEFAULT_DIR / "telemetry.json"
