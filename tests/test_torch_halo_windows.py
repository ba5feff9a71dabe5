"""ROADMAP C5: the merge's halo in-flight windows on the port.

The port records every blocking exchange of a model's step from the host
(a ``halo.exchange`` span), where the JAX package's sit inside its jitted
step unseen.  In the telemetry gate's split drive (start, the interior
step with its own blocking exchange, wait) the JAX rule "a ``halo.start``
pairs with the next ``halo.exchange``" closed each window at the interior
step's own exchange, before its compute: on the card the split advection
round measured ``overlap.fraction{phase=halo}`` 0.0.  The split finish now
carries ``obs.events.HALO_FINISH`` and the merge pairs each start with the
next marked span; a timeline without marks (the JAX package's) pairs as
before."""
import os
import sys

import numpy as np
import pytest

from dccrg_tpu.obs.events import EventTimeline as JTimeline
from dccrg_tpu.obs.merge import build_merged as j_build_merged
from dccrg_tpu_torch import obs
from dccrg_tpu_torch.obs import kineto
from dccrg_tpu_torch.obs.events import HALO_FINISH, EventTimeline
from dccrg_tpu_torch.obs.merge import build_merged

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_trace_merge import KERNELS, _kineto_json, _us  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _timeline_as_found():
    """The gate and the probe enable the process's event timeline; the
    other tests on this worker export it, so this module leaves it as it
    found it."""
    from dccrg_tpu_torch import obs

    was = obs.timeline.enabled
    yield
    obs.timeline.enabled = was
    if not was:
        obs.timeline.clear()


def _merge(tmp_path, marked: bool):
    """The split drive's shape: start [10, 11] ms, the interior step's
    own blocking exchange [11.5, 12], its compute on the device [12, 15],
    the wait [15, 16] (marked or not); the ring copy [11.2, 11.5] and two
    edge kernels at 9 and 16.9 ms that open the profiled window."""
    host = [("halo.start", 10.0, 1.0, None), ("halo.exchange", 11.5, 0.5, None),
            ("halo.exchange", 15.0, 1.0, HALO_FINISH if marked else None)]
    dev = [("pad", 9.0, 0.1), ("halo", 11.2, 0.3), ("step", 12.0, 3.0), ("pad", 16.9, 0.1)]
    tl = EventTimeline(enabled=True)
    for name, ms, dur, args in host:
        tl.add(name, tl.origin_perf + ms * 1e-3, dur * 1e-3, args)
    _kineto_json(tmp_path / "h_1.1.pt.trace.json", tl, dev, [0.5, 0.75, 17.5])
    labels = {sym: lab for _name, sym, lab in KERNELS.values()}
    return build_merged(ingest=kineto.ingest(str(tmp_path)), timeline=tl,
                        kernel_labels=labels), tl, host, dev, labels


def test_start_pairs_with_the_marked_finish(tmp_path):
    merged, *_ = _merge(tmp_path, marked=True)
    ov = merged.summary()["overlap"]["halo"]
    assert ov["inflight_s"] == pytest.approx(6e-3, rel=1e-6)
    assert ov["overlap_s"] == pytest.approx(3e-3, rel=1e-6)
    assert ov["fraction"] == pytest.approx(0.5, abs=1e-6)


def test_unmarked_timeline_pairs_as_the_jax_package(tmp_path):
    """Without a mark the window closes at the step's own exchange, and
    the port's summary is the JAX merge's of the same intervals."""
    from dccrg_tpu.obs import xplane as jxp

    merged, tl, host, dev, labels = _merge(tmp_path, marked=False)
    ov = merged.summary()["overlap"]["halo"]
    assert ov["fraction"] == 0.0
    jtl = JTimeline(enabled=True)
    jtl.rebase(tl.origin_perf, tl.origin_wall)
    for name, ms, dur, _args in host:
        jtl.add(name, tl.origin_perf + ms * 1e-3, dur * 1e-3)
    spans = sorted((jxp.KernelSpan(KERNELS[k][0], KERNELS[k][1], _us(tl, ms) * 1e3,
                                   dur * 1e6) for k, ms, dur in dev),
                   key=lambda s: s.start_ns)
    markers = [jxp.HostMarker(f"{jxp.CLOCK_SYNC_TAG}:{round(tl.origin_perf * 1e9 + b * 1e6)}",
                              float(round((round(tl.origin_perf * 1e9 + b * 1e6)
                                           + 5_000_000_000_000) / 1e3)) * 1e3, 1e3)
               for b in (0.5, 0.75, 17.5)]
    jing = jxp.XIngest(["synthetic"], [jxp.ExecLine(0, "/device:CUDA:0", "device", spans)],
                       markers, ["kernel"])
    jov = j_build_merged(ingest=jing, timeline=jtl,
                         kernel_labels=labels).summary()["overlap"]["halo"]
    assert ov == jov


def test_split_drive_marks_only_the_finish():
    """On the CPU: the gate's split drive records the wait's
    ``halo.exchange`` with ``HALO_FINISH`` and the interior step's own
    exchanges without it, and each start's window closes at its wait."""
    from dccrg_tpu_torch.tools import check_telemetry as ct

    g, adv, state, dt = ct.build_workload("cpu")
    obs.enable()
    obs.enable_timeline()
    obs.timeline.clear()
    state = ct.drive_split(g, adv, state, dt, 2)
    assert np.isfinite(adv.total_mass(state))
    spans = [s for s in obs.timeline.spans() if s["name"].startswith("halo.")]
    names = [(s["name"], (s["args"] or {}).get("halo")) for s in spans]
    # a step: start, the interior step's exchange, the wait, the
    # boundary step's exchange
    assert names == [("halo.start", None), ("halo.exchange", None),
                     ("halo.exchange", "finish"), ("halo.exchange", None)] * 2
    merged = build_merged(ingest=kineto.ingest(os.devnull), timeline=obs.timeline)
    t0 = obs.timeline.origin_perf
    ends = [(s["begin"] - t0 + s["dur"]) * 1e6 for s in spans
            if (s["args"] or {}).get("halo") == "finish"]
    windows = merged._halo_windows()
    for e in ends:
        assert any(abs(b - e) < 1e-3 for _a, b in windows), (e, windows)


def test_phase_add_records_each_span_at_once():
    """The halo seam's recorder (``phase_add``, called on every exchange)
    puts each span into the phase table and its duration histogram when
    it is called, with its args on the timeline: 10^4 spans with no read
    between them leave nothing queued, so a run that never reads a report
    holds a bounded registry."""
    from dccrg_tpu_torch.obs.registry import MetricsRegistry

    r = MetricsRegistry()
    r.duration_histograms = True
    r.timeline = EventTimeline(enabled=True)
    fresh = set(vars(r))
    for _ in range(10_000):
        r.phase_add("halo.exchange", 1e-6, HALO_FINISH)
    assert r._phases["halo.exchange"][1] == 10_000
    assert r._phases["halo.exchange"][0] == pytest.approx(1e-2)
    (hist,) = [h for (name, _labels), h in r._hists.items() if name == "phase.duration_s"]
    assert hist[0] == 10_000
    assert set(vars(r)) == fresh and len(r._duration_keys) == 1
    assert r.timeline.spans()[-1]["args"] == HALO_FINISH
