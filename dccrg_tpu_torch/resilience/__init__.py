"""Resilience layer: deterministic fault injection + crash-safe
checkpoint lineage (the JAX package's ``resilience``, ported).

The reference dccrg earns its production role through restart
discipline — ``save_grid_data``'s offset-table format reloads on any
process count (Honkonen et al., CPC 2013) — and HPC practice layers
rotating multi-generation checkpoints on top so a torn write never
strands a run (Moody et al., SC'10).  This package is the part that
*proves* recovery works:

* :mod:`~dccrg_tpu_torch.resilience.inject` — a seeded, site-addressable
  fault-injection plane (``DCCRG_FAULT=site:prob:seed`` or the
  :class:`FaultPlane` API): torn/partial checkpoint writes, bit flips
  in saved bytes, NaN storms in halo payloads, and
  SIGKILL-at-phase-boundary hooks for child processes.  Every trigger
  is counted in the obs registry (``resilience.injected{site=...}``).
* :mod:`~dccrg_tpu_torch.resilience.manager` — rotating keep-N checkpoint
  generations with fsync'd atomic commits and a checksummed MANIFEST;
  ``latest_valid()`` scans back past torn/corrupt generations and
  re-verifies the restored grid.

The hardened checkpoint format itself (CRC32 over header, offset
table, and per-cell payload chunks; typed :class:`CheckpointError`;
``on_error="salvage"``) lives in ``io/checkpoint.py``.
``python -m dccrg_tpu_torch.resilience.soak crash`` is the end-to-end
proof harness: a SIGKILLed child must resume from ``latest_valid()``
and converge to the uninterrupted run's final state across slot-count
changes.

On top of recovery sits the **elastic fleet**:

* :mod:`~dccrg_tpu_torch.resilience.elastic` — :func:`rescale` re-lands
  a live grid on more or fewer slots through a committed lineage
  generation (verified, counted ``elastic.rescales{direction}``), and
  :class:`ElasticPolicy` drives it from live HBM/step-latency/backlog
  signals with hysteresis + cooldown so the fleet never flaps;
* :mod:`~dccrg_tpu_torch.resilience.supervisor` — a heartbeat watchdog
  tailing the streaming-JSONL telemetry, escalating stalled or dead
  workers through warn → degraded rescale-down → restart-from-
  ``latest_valid()`` (the ``device.lost`` / ``step.hang`` fault sites
  prove every branch);
* zero-cold-start warm restart — the kernels are one library per CUDA
  source (``cuda_build``: the file name hashes the source and the flags,
  whatever the grid's shape or slot count), so a restarted or rescaled
  worker that finds the libraries on disk records
  ``epoch.recompiles == 0``.  ``python -m dccrg_tpu_torch.resilience.soak
  elastic`` is the proof harness for all three.
"""
from .inject import (
    FaultPlane, plane, fires, maybe_kill, corrupt_array, maybe_hang,
)
from .manager import CheckpointLineage
from .elastic import (
    DeviceLostError,
    ElasticPolicy,
    RescaleResult,
    available_devices,
    queue_depth_signal,
    rescale,
    step_latency_signal,
    utilization_signal,
)
from .supervisor import EscalationLadder, HeartbeatMonitor, Supervisor

__all__ = [
    "FaultPlane",
    "plane",
    "fires",
    "maybe_kill",
    "corrupt_array",
    "maybe_hang",
    "CheckpointLineage",
    "DeviceLostError",
    "ElasticPolicy",
    "RescaleResult",
    "available_devices",
    "queue_depth_signal",
    "rescale",
    "step_latency_signal",
    "utilization_signal",
    "EscalationLadder",
    "HeartbeatMonitor",
    "Supervisor",
]
