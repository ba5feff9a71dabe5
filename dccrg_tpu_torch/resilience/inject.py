"""Deterministic, site-addressable fault injection (a copy of the JAX
package's ``resilience/inject.py``).

Every fault has a *site name* (``"checkpoint.bit_flip"``,
``"p2p.recv"``, ...).  Production code asks the process-wide
:data:`plane` whether a site *fires* at each potential fault point; an
unarmed site is a single dict lookup returning False, so the hooks are
free in normal operation.  Armed sites draw from their own seeded RNG,
which makes every failure pattern reproducible: the same seed injects
the same faults at the same points.

Arming:

* API — ``plane.arm("checkpoint.torn_write", prob=0.2, seed=7)``;
* environment — ``DCCRG_FAULT=site:prob:seed[:count[:after]]`` with
  multiple comma-separated specs, parsed once at import (and again on
  :meth:`FaultPlane.load_env`), which is how child processes (soak
  crash harness, multiprocess workers) receive their fault schedule.

``count`` bounds how many times the site may fire (default unlimited);
``after`` skips the first N evaluations before the site becomes
eligible (e.g. "die at the SECOND checkpoint commit": ``prob=1,
count=1, after=1``).

Sites wired into the codebase:

=========================  ====================================================
``checkpoint.bit_flip``    flip one random bit in the payload bytes of a
                           checkpoint as it is written (``io/checkpoint.py``)
``checkpoint.torn_write``  truncate a checkpoint file to a random fraction
                           after writing — a torn write at the final path
``p2p.connect``            fail a controller p2p connect (``utils/collectives``)
``p2p.accept``             fail a controller p2p accept
``p2p.recv``               fail a controller p2p recv
``halo.nan``               poison random rows of halo payload fields with NaN
                           before an exchange (``parallel/halo.py``)
``sigkill.post_commit``    SIGKILL the process right after a checkpoint
                           lineage commit (``resilience/manager.py``)
``device.lost``            raise ``DeviceLostError`` at a device-availability
                           check (``resilience/elastic.py``) or a supervised
                           step boundary — the degraded-rescale trigger
``step.hang``              wedge the step loop (:func:`maybe_hang`) so the
                           supervisor's heartbeat watchdog sees a stall
                           (``resilience/supervisor.py``, ``tools/soak.py``)
=========================  ====================================================

Every trigger is counted as ``resilience.injected{site=...}`` in the obs
registry.  Only the
two checkpoint sites are wired into this package so far
(``io/checkpoint.py``); the others are named for the resilience layer that
arms them.
"""
from __future__ import annotations

import os
import threading

import numpy as np

from ..obs.registry import metrics

__all__ = ["FaultPlane", "plane", "fires", "maybe_kill", "corrupt_array",
           "maybe_raise", "maybe_hang", "torn_fraction"]


class _Site:
    __slots__ = ("name", "prob", "rng", "remaining", "after", "fired")

    def __init__(self, name, prob, seed, count, after):
        self.name = str(name)
        self.prob = float(prob)
        self.rng = np.random.default_rng(seed)
        self.remaining = None if count is None else int(count)
        self.after = int(after)
        self.fired = 0


class FaultPlane:
    """Registry of armed fault sites; thread-safe, deterministic."""

    def __init__(self):
        self._sites: dict[str, _Site] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ arming

    def arm(self, site: str, prob: float = 1.0, seed: int = 0,
            count: int | None = None, after: int = 0) -> None:
        """Arm ``site`` to fire with probability ``prob`` per
        evaluation, at most ``count`` times total, skipping the first
        ``after`` evaluations.  Re-arming replaces the site (fresh RNG,
        fresh budget)."""
        if not 0.0 <= float(prob) <= 1.0:
            raise ValueError(f"fault probability {prob} outside [0, 1]")
        with self._lock:
            self._sites[str(site)] = _Site(site, prob, seed, count, after)

    def disarm(self, site: str | None = None) -> None:
        """Disarm one site, or every site when ``site`` is None."""
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(str(site), None)

    def armed(self, site: str) -> bool:
        return str(site) in self._sites

    def load_env(self, spec: str | None = None) -> None:
        """Parse ``DCCRG_FAULT`` (or an explicit spec string):
        comma-separated ``site[:prob[:seed[:count[:after]]]]`` entries.
        An empty spec disarms nothing (explicitly pass ``""`` specs via
        :meth:`disarm`)."""
        if spec is None:
            spec = os.environ.get("DCCRG_FAULT", "")
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            site = parts[0]
            prob = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
            seed = int(parts[2]) if len(parts) > 2 and parts[2] else 0
            count = int(parts[3]) if len(parts) > 3 and parts[3] else None
            after = int(parts[4]) if len(parts) > 4 and parts[4] else 0
            self.arm(site, prob=prob, seed=seed, count=count, after=after)

    # ------------------------------------------------------------ firing

    def fires(self, site: str, **labels) -> bool:
        """Whether an armed ``site`` fires at this evaluation.  Unarmed
        sites cost one dict lookup.  Each firing is counted as
        ``resilience.injected{site=...}`` in the obs registry."""
        s = self._sites.get(site)
        if s is None:
            return False
        with self._lock:
            if s.after > 0:
                s.after -= 1
                return False
            if s.remaining is not None and s.remaining <= 0:
                return False
            if s.prob < 1.0 and s.rng.random() >= s.prob:
                return False
            if s.remaining is not None:
                s.remaining -= 1
            s.fired += 1
        metrics.inc("resilience.injected", site=site, **labels)
        return True

    def site_rng(self, site: str) -> np.random.Generator:
        """The armed site's RNG — fault *payload* decisions (which bit
        to flip, how much to truncate) draw from the same seeded stream
        as the fire decisions, so a seed reproduces the whole fault."""
        return self._sites[str(site)].rng

    def fired(self, site: str) -> int:
        """How many times ``site`` has fired since it was armed."""
        s = self._sites.get(str(site))
        return 0 if s is None else s.fired

    def report(self) -> dict:
        """Armed-site snapshot ``{site: {prob, fired, remaining}}``."""
        with self._lock:
            return {
                name: {"prob": s.prob, "fired": s.fired,
                       "remaining": s.remaining, "after": s.after}
                for name, s in sorted(self._sites.items())
            }


#: process-wide fault plane; armed from ``DCCRG_FAULT`` at import so
#: child processes receive their fault schedule purely via environment
plane = FaultPlane()
plane.load_env()


def fires(site: str, **labels) -> bool:
    """Module-level shorthand for ``plane.fires``."""
    return plane.fires(site, **labels)


def maybe_kill(site: str) -> None:
    """SIGKILL this process if ``site`` fires — the phase-boundary
    crash hook (no cleanup, no atexit, no flushing: exactly the failure
    a power loss or OOM-kill produces).  By design nothing is guaranteed
    to survive except what was already fsync'd."""
    if plane.fires(site):
        import signal

        os.kill(os.getpid(), signal.SIGKILL)


def corrupt_array(buf: np.ndarray, site: str = "checkpoint.bit_flip",
                  **labels) -> bool:
    """Flip one random bit of a uint8 array in place if ``site`` fires.
    Returns whether a flip happened."""
    if len(buf) == 0 or not plane.fires(site, **labels):
        return False
    rng = plane.site_rng(site)
    i = int(rng.integers(len(buf)))
    buf[i] ^= np.uint8(1 << int(rng.integers(8)))
    return True


def torn_fraction(site: str = "checkpoint.torn_write") -> float | None:
    """A random fraction in (0, 1) to truncate a file to if ``site``
    fires, else None."""
    if not plane.fires(site):
        return None
    return float(plane.site_rng(site).uniform(0.02, 0.98))


def maybe_raise(site: str, exc: type = ConnectionResetError,
                **labels) -> None:
    """Raise ``exc`` if ``site`` fires — socket-failure injection for
    the p2p transport seams (and, with
    a ``DeviceLostError``, the
    ``device.lost`` site at supervised step boundaries)."""
    if plane.fires(site, **labels):
        raise exc(f"injected fault at site {site!r}")


def maybe_hang(site: str = "step.hang", seconds: float = 3600.0,
               **labels) -> bool:
    """Sleep ``seconds`` if ``site`` fires — the wedged-step injection:
    the process stays alive but stops making progress, which is exactly
    the failure only a heartbeat watchdog (``resilience/supervisor.py``)
    can detect.  Returns whether the hang fired (the supervisor normally
    kills the process long before the sleep returns)."""
    if plane.fires(site, **labels):
        import time

        time.sleep(float(seconds))
        return True
    return False
