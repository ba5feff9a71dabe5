"""The port's fault plane, checkpoint lineage and halo NaN-storm seam
(``dccrg_tpu_torch.resilience``, on the CPU) against the JAX package's
(tests/test_resilience.py mirrored): the same calls on the same seeded
inputs give the same decisions, files, resumed states and registry deltas
in both packages; a lineage directory written by either package resumes
in the other bitwise; a SIGKILLed port child resumes bit-identically.

Tolerances: none — every comparison is exact (bytes, ids, bits).
"""
import glob
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu import obs as jobs
from dccrg_tpu.resilience import plane as jplane
from dccrg_tpu_torch import GameOfLife, Grid, obs
from dccrg_tpu_torch.io.checkpoint import CheckpointError
from dccrg_tpu_torch.resilience import CheckpointLineage, FaultPlane, plane
from dccrg_tpu_torch.resilience.manager import MANIFEST_NAME

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    plane.disarm()
    jplane.disarm()


def _mesh_kw(pkg, n_dev):
    return ({"mesh": dccrg_tpu.make_mesh(n_devices=n_dev)} if pkg is dccrg_tpu
            else {"n_devices": n_dev, "device": "cpu"})


def _resume(pkg, d, spec, n_dev):
    """``Grid.resume_latest`` of either package on the CPU."""
    return pkg.Grid.resume_latest(d, spec, **_mesh_kw(pkg, n_dev))


# ------------------------------------------------------------ inject plane


def _plane_sequences(P):
    p = P()
    out = {"unarmed": (p.fires("nope"), p.fired("nope"))}
    p.arm("x", prob=0.5, seed=42)
    first = [p.fires("x") for _ in range(50)]
    p.arm("x", prob=0.5, seed=42)      # re-arm resets RNG + budget
    out["x"] = (first, [p.fires("x") for _ in range(50)])
    p.arm("y", prob=1.0, seed=0, count=3)
    out["y"] = [p.fires("y") for _ in range(5)]
    p.arm("z", prob=1.0, seed=0, count=1, after=2)
    out["z"] = [p.fires("z") for _ in range(4)]
    p.load_env("a:0.25:7:3:2, b , c:1.0")
    out["report"] = p.report()
    return out


def test_plane_matches_jax_decisions_budgets_and_env():
    """The same arm / fire / env-spec calls give the same decisions, the
    same budgets and the same report in both packages (seeded draws)."""
    from dccrg_tpu.resilience import FaultPlane as JFaultPlane

    got = _plane_sequences(FaultPlane)
    assert got == _plane_sequences(JFaultPlane)
    assert got["unarmed"] == (False, 0)
    first, again = got["x"]
    assert first == again and any(first) and not all(first)
    assert got["y"] == [True, True, True, False, False]
    assert got["z"] == [False, False, True, False]
    assert got["report"]["a"] == {"prob": 0.25, "fired": 0, "remaining": 3,
                                  "after": 2}
    with pytest.raises(ValueError, match="probability"):
        FaultPlane().arm("w", prob=1.5)


def test_plane_firings_counted_in_registry():
    before = obs.metrics.counter_value("resilience.injected", site="unit.test")
    plane.arm("unit.test", prob=1.0, seed=0, count=2)
    assert plane.fires("unit.test") and plane.fires("unit.test")
    assert not plane.fires("unit.test")
    assert obs.metrics.counter_value(
        "resilience.injected", site="unit.test") == before + 2


# ------------------------------------------------------------- halo.nan


def _storm_grid(pkg):
    g = (pkg.Grid().set_initial_length((4, 4, 1)).set_neighborhood_length(1)
         .set_periodic(True, True, False).initialize(**_mesh_kw(pkg, 2)))
    spec = {"q": ((), np.float64), "w": ((3,), np.float32),
            "n": ((), np.int32)}
    cells = g.get_cells()
    s = g.new_state(spec)
    s = g.set_cell_data(s, "q", cells, np.arange(len(cells), dtype=float))
    s = g.set_cell_data(s, "w", cells, np.ones((len(cells), 3), np.float32))
    return g, s, spec


def _nan_mask(state):
    return {k: np.isnan(np.asarray(v, dtype=np.float64)) for k, v in state.items()}


def test_halo_nan_storm_detected_by_verify_finite():
    """One armed blocking exchange poisons its payload: ``verify_finite``
    raises, ``resilience.injected{site=halo.nan}`` rises by 1, the input
    state is unchanged, and the next, disarmed exchange is clean."""
    from dccrg_tpu_torch.utils.verify import verify_finite

    g, state, spec = _storm_grid(dccrg_tpu_torch)
    state = g.update_copies_of_remote_neighbors(state)
    verify_finite(g, state, spec)
    before = {k: v.clone() for k, v in state.items()}
    inj0 = obs.metrics.counter_value("resilience.injected", site="halo.nan")
    rows0 = obs.metrics.counter_value("resilience.nan_rows_poisoned")
    plane.arm("halo.nan", prob=1.0, seed=5, count=1)
    stormed = g.update_copies_of_remote_neighbors(state)
    assert obs.metrics.counter_value("resilience.injected",
                                     site="halo.nan") == inj0 + 1
    # two floating fields (q, w), min(4, R) rows each; the int field is spared
    assert obs.metrics.counter_value("resilience.nan_rows_poisoned") == rows0 + 8
    with pytest.raises(AssertionError, match="non-finite"):
        verify_finite(g, stormed, spec)
    for k, v in state.items():
        assert torch.equal(v, before[k]), f"the input field {k} changed"
    plane.disarm("halo.nan")
    verify_finite(g, g.update_copies_of_remote_neighbors(state), spec)


@pytest.mark.parametrize("seed", [5, 11])
def test_halo_nan_storm_poisons_the_jax_rows(seed):
    """The same seed poisons the same ``(slot, row)`` pairs of the same
    fields as the JAX package, before the exchange and after it."""
    from dccrg_tpu.parallel.halo import _maybe_nan_storm as jstorm
    from dccrg_tpu_torch.parallel.halo import _maybe_nan_storm as pstorm

    jg, js, _ = _storm_grid(dccrg_tpu)
    pg, ps, _ = _storm_grid(dccrg_tpu_torch)
    assert (jg.epoch.n_devices, jg.epoch.R) == (pg.epoch.n_devices, pg.epoch.R)
    jplane.arm("halo.nan", prob=1.0, seed=seed, count=2)
    plane.arm("halo.nan", prob=1.0, seed=seed, count=2)
    jm, pm = _nan_mask(jstorm(js)), _nan_mask(pstorm(ps))
    assert set(jm) == set(pm)
    for k in jm:
        np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)
    assert pm["q"].any() and pm["w"].any() and not pm["n"].any()
    # the second firing, through each package's blocking exchange
    jm = _nan_mask(jg.update_copies_of_remote_neighbors(js))
    pm = _nan_mask(pg.update_copies_of_remote_neighbors(ps))
    for k in jm:
        np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)
    assert not _nan_mask(ps)["q"].any()


def test_unarmed_seam_is_one_lookup(monkeypatch):
    """Unarmed, the seam asks the plane one question (``armed``), never
    ``fires``, and hands the caller's state back untouched: no copy, no
    device work."""
    from dccrg_tpu_torch.parallel import halo

    def boom(*a, **k):
        raise AssertionError("fires() called on an unarmed site")

    monkeypatch.setattr(plane, "fires", boom)
    g, s, _ = _storm_grid(dccrg_tpu_torch)
    assert halo._maybe_nan_storm(s) is s
    g.update_copies_of_remote_neighbors(s)


# ------------------------------------------------------------ lineage


SPEC = {"v": ((), np.float64)}


def _small_grid(pkg=dccrg_tpu_torch, n_devices=2):
    g = (pkg.Grid().set_initial_length((4, 4, 1)).set_neighborhood_length(1)
         .initialize(**_mesh_kw(pkg, n_devices)))
    cells = g.get_cells()
    state = g.set_cell_data(g.new_state(SPEC), "v", cells,
                            np.arange(len(cells), dtype=float))
    return g, state, cells


def test_lineage_commit_rotate_resume(tmp_path):
    g, state, cells = _small_grid()
    d = str(tmp_path / "lin")
    lin = CheckpointLineage(d, keep=3)
    for i in range(5):
        state = g.set_cell_data(state, "v", cells, np.full(len(cells), float(i)))
        assert lin.commit(g, state, SPEC, user_header=str(i).encode()) == i + 1
    assert [e["gen"] for e in lin.generations()] == [3, 4, 5]
    assert len(glob.glob(os.path.join(d, "gen-*.dc"))) == 3
    g2, s2, hdr, gen = Grid.resume_latest(d, SPEC, n_devices=1, device="cpu")
    assert (gen, hdr) == (5, b"4") and g2.device.type == "cpu"
    np.testing.assert_array_equal(g2.get_cell_data(s2, "v", cells),
                                  np.full(len(cells), 4.0))


def test_save_checkpoint_and_resume_default_to_cuda(tmp_path):
    """``Grid.save_checkpoint`` commits generations; ``resume_latest``
    without ``device=`` asks for CUDA and, where there is none, raises
    instead of landing on the CPU."""
    g, state, cells = _small_grid()
    d = str(tmp_path / "lin")
    assert [g.save_checkpoint(state, d, SPEC, keep=2) for _ in range(3)] == [1, 2, 3]
    assert [e["gen"] for e in CheckpointLineage(d).generations()] == [2, 3]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default lands there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Grid.resume_latest(d, SPEC, n_devices=1)


def _corrupt_newest_two(d):
    files = sorted(glob.glob(os.path.join(d, "gen-*.dc")))
    with open(files[-1], "r+b") as f:        # torn mid-payload
        f.truncate(os.path.getsize(files[-1]) - 11)
    with open(files[-2], "r+b") as f:        # one bit flipped
        f.seek(os.path.getsize(files[-2]) - 5)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x01]))


def _skips(o):
    return {r: o.metrics.counter_value("lineage.generations_skipped", reason=r)
            for r in ("size", "file_crc")}


def test_lineage_scans_past_torn_and_corrupt_generations(tmp_path):
    """The newest generation torn and the second-newest bit-flipped: both
    packages skip both with the same file-level evidence and resume the
    same generation."""
    out = {}
    for pkg, o in ((dccrg_tpu, jobs), (dccrg_tpu_torch, obs)):
        g, state, cells = _small_grid(pkg)
        d = str(tmp_path / pkg.__name__)
        lin = pkg.resilience.CheckpointLineage(d, keep=4)
        for i in range(4):
            lin.commit(g, state, SPEC, user_header=str(i).encode())
        _corrupt_newest_two(d)
        before = _skips(o)
        g2, s2, hdr, gen = _resume(pkg, d, SPEC, 2)
        after = _skips(o)
        out[pkg.__name__] = ((gen, hdr), {r: after[r] - before[r] for r in after},
                             np.asarray(g2.get_cell_data(s2, "v", cells)))
    (pres, pdelta, pv), (jres, jdelta, jv) = out["dccrg_tpu_torch"], out["dccrg_tpu"]
    assert pres == jres == (2, b"1")
    assert pdelta == jdelta and sum(pdelta.values()) >= 2
    np.testing.assert_array_equal(pv, jv)


def test_lineage_torn_manifest_falls_back_to_scan(tmp_path):
    g, state, cells = _small_grid()
    d = str(tmp_path / "lin")
    lin = CheckpointLineage(d, keep=3)
    for i in range(3):
        lin.commit(g, state, SPEC, user_header=str(i).encode())
    with open(os.path.join(d, MANIFEST_NAME), "r+b") as f:
        f.truncate(17)
    before = obs.metrics.counter_value("lineage.manifest_torn")
    g2, s2, hdr, gen = Grid.resume_latest(d, SPEC, n_devices=1, device="cpu")
    assert (gen, hdr) == (3, b"2")
    assert obs.metrics.counter_value("lineage.manifest_torn") > before
    # a later commit re-adopts the scanned generations and heals the manifest
    assert lin.commit(g, state, SPEC, user_header=b"healed") == 4
    entries, healthy = lin._read_manifest()
    assert healthy and [e["gen"] for e in entries] == [2, 3, 4]


def test_lineage_rejects_torn_commit_and_keeps_previous(tmp_path):
    g, state, cells = _small_grid()
    d = str(tmp_path / "lin")
    lin = CheckpointLineage(d, keep=2)
    lin.commit(g, state, SPEC, user_header=b"good")
    rej0 = sum(obs.metrics.report()["counters"]
               .get("lineage.commit_rejected", {}).values())
    plane.arm("checkpoint.torn_write", prob=1.0, seed=1, count=1)
    with pytest.raises(CheckpointError, match="lineage") as ei:
        lin.commit(g, state, SPEC, user_header=b"torn")
    plane.disarm("checkpoint.torn_write")
    assert ei.value.section == "lineage"
    assert sum(obs.metrics.report()["counters"]["lineage.commit_rejected"]
               .values()) == rej0 + 1
    assert obs.metrics.counter_value("resilience.injected",
                                     site="checkpoint.torn_write") >= 1
    g2, s2, hdr, gen = Grid.resume_latest(d, SPEC, n_devices=1, device="cpu")
    assert (gen, hdr) == (1, b"good")
    # the torn stray neither occupies a keep slot nor survives the next
    # successful rotation
    lin.commit(g, state, SPEC, user_header=b"after")
    lin.commit(g, state, SPEC, user_header=b"after2")
    assert Grid.resume_latest(d, SPEC, n_devices=1, device="cpu")[2] == b"after2"


def test_lineage_skips_bitflipped_generation_via_payload_crc(tmp_path):
    """A generation written with a flipped bit is detected by CRC, skipped
    by the scan, and salvage recovers every intact cell onto the asked
    device — the same generation, header and lost cells as the JAX
    package's for the same seed."""
    out = {}
    for pkg, o in ((dccrg_tpu, jobs), (dccrg_tpu_torch, obs)):
        P = pkg.resilience.plane
        g, state, cells = _small_grid(pkg)
        d = str(tmp_path / pkg.__name__)
        lin = pkg.resilience.CheckpointLineage(d, keep=3)
        clean = lin.commit(g, state, SPEC, user_header=b"clean")
        P.arm("checkpoint.bit_flip", prob=1.0, seed=2, count=1)
        flipped = lin.commit(g, state, SPEC, user_header=b"flipped")
        P.disarm("checkpoint.bit_flip")
        crc0 = o.metrics.counter_value("checkpoint.crc_failures", section="payload")
        skip0 = o.metrics.counter_value("lineage.generations_skipped",
                                        reason="payload")
        g2, s2, hdr, gen = _resume(pkg, d, SPEC, 2)
        assert (gen, hdr) == (clean, b"clean")
        assert o.metrics.counter_value("checkpoint.crc_failures",
                                       section="payload") > crc0
        assert o.metrics.counter_value("lineage.generations_skipped",
                                       reason="payload") == skip0 + 1
        g3, s3, hdr3, gen3, lost = lin.salvage_latest(SPEC, **_mesh_kw(pkg, 1))
        assert gen3 == flipped and hdr3 == b"flipped" and len(lost) == 1
        keep = ~np.isin(cells, lost)
        np.testing.assert_array_equal(
            np.asarray(g3.get_cell_data(s3, "v", cells[keep])),
            np.asarray(g.get_cell_data(state, "v", cells[keep])))
        out[pkg.__name__] = (gen3, np.asarray(lost),
                             open(os.path.join(d, "gen-000002.dc"), "rb").read())
    assert out["dccrg_tpu_torch"][0] == out["dccrg_tpu"][0]
    np.testing.assert_array_equal(out["dccrg_tpu_torch"][1], out["dccrg_tpu"][1])
    assert out["dccrg_tpu_torch"][2] == out["dccrg_tpu"][2]
    assert g3.device.type == "cpu"


def test_lineage_empty_directory_raises(tmp_path):
    with pytest.raises(CheckpointError, match="no valid generation"):
        CheckpointLineage(str(tmp_path / "empty")).latest_valid(
            SPEC, n_devices=1, device="cpu")


def test_two_to_one_post_build_oracle_message():
    """grid.py's defensive post-build balance check raises the documented
    message when the epoch's neighbor tables carry a >2x length ratio."""
    g = (Grid().set_initial_length((4, 4, 4)).set_maximum_refinement_level(2)
         .set_neighborhood_length(1).initialize(n_devices=1, device="cpu"))
    hood = g.epoch.hoods[None]
    orig = hood.nbr_len
    try:
        fake = orig.copy()
        i = tuple(np.argwhere(hood.nbr_valid)[0])
        fake[i] = fake[i] * 4
        hood.nbr_len = fake
        with pytest.raises(ValueError,
                           match=r"violates 2:1 balance \(corrupt checkpoint\?\)"):
            g._validate_two_to_one()
    finally:
        hood.nbr_len = orig


# ------------------------------------------- one lineage, both packages


def _gol_lineage(pkg, d, n_dev=2, gens=3):
    """A 6x6 Game of Life board from a seeded start, committed after each
    of ``gens`` turns (keep 2) — the same calls in either package."""
    g = (pkg.Grid().set_initial_length((6, 6, 1)).set_neighborhood_length(1)
         .set_periodic(True, True, False).initialize(**_mesh_kw(pkg, n_dev)))
    cells = g.get_cells()
    gol = pkg.GameOfLife(g) if pkg is dccrg_tpu_torch else \
        dccrg_tpu.models.GameOfLife(g)
    s = gol.new_state(alive_cells=cells[np.random.default_rng(3).random(len(cells)) < 0.4])
    lin = pkg.resilience.CheckpointLineage(d, keep=2)
    for t in range(gens):
        s = gol.run(s, 1)
        lin.commit(g, s, GameOfLife.SPEC, user_header=str(t + 1).encode())
    return g, s, cells


def test_lineage_files_are_byte_identical_across_packages(tmp_path):
    """The same grid and state committed by each package leave the same
    directory: MANIFEST.json and every gen-*.dc byte for byte."""
    import dccrg_tpu.models  # noqa: F401 — GameOfLife of the JAX package

    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    _gol_lineage(dccrg_tpu, jd)
    _gol_lineage(dccrg_tpu_torch, pd)
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(pd)) == [
        "MANIFEST.json", "gen-000002.dc", "gen-000003.dc"]
    for name in names:
        with open(os.path.join(jd, name), "rb") as a, \
                open(os.path.join(pd, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("n_dev", [1, 3])
def test_each_package_resumes_the_others_lineage(tmp_path, writer, reader, n_dev):
    """A lineage committed by one package resumes in the other at the newest
    generation, on another slot count, with every field bitwise equal by
    cell id."""
    import dccrg_tpu.models  # noqa: F401

    pkgs = {"jax": dccrg_tpu, "port": dccrg_tpu_torch}
    d = str(tmp_path / "lin")
    g, s, cells = _gol_lineage(pkgs[writer], d)
    g2, s2, hdr, gen = pkgs[reader].resilience.CheckpointLineage(d).latest_valid(
        GameOfLife.SPEC, **_mesh_kw(pkgs[reader], n_dev))
    assert (gen, hdr) == (3, b"3") and g2.n_devices == n_dev
    np.testing.assert_array_equal(g2.get_cells(), cells)
    for f in GameOfLife.SPEC:
        np.testing.assert_array_equal(np.asarray(g2.get_cell_data(s2, f, cells)),
                                      np.asarray(g.get_cell_data(s, f, cells)),
                                      err_msg=f)


# ------------------------------------------------- crash smoke (CI speed)


CRASH_SMOKE_CHILD = r"""
import os, sys
wd = sys.argv[1]
import numpy as np
sys.path.insert(0, {root!r})
from dccrg_tpu_torch import GameOfLife, Grid
from dccrg_tpu_torch.resilience.manager import CheckpointLineage

g = (Grid().set_initial_length((6, 6, 1)).set_neighborhood_length(1)
     .set_periodic(True, True, False).initialize(n_devices=1, device="cpu"))
cells = g.get_cells()
alive0 = cells[np.random.default_rng(0).random(len(cells)) < 0.4]
lineage = CheckpointLineage(os.path.join(wd, 'gol'), keep=3)
gol = GameOfLife(g)
s = gol.new_state(alive_cells=alive0)
step = 0
while step < 8:
    s = gol.run(s, 1)
    step += 1
    lineage.commit(g, s, GameOfLife.SPEC, user_header=str(step).encode())
print('CHILD_COMPLETED', flush=True)
"""


@pytest.fixture(scope="module")
def killed_child(tmp_path_factory):
    """A port child that SIGKILLs itself right after its second commit
    (``sigkill.post_commit:1:0:1:1``); returns its workdir."""
    wd = str(tmp_path_factory.mktemp("crash"))
    env = {**os.environ, "DCCRG_FAULT": "sigkill.post_commit:1:0:1:1"}
    r = subprocess.run(
        [sys.executable, "-c", CRASH_SMOKE_CHILD.format(root=ROOT), wd],
        capture_output=True, text=True, env=env, timeout=240)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stdout, r.stderr)
    assert "CHILD_COMPLETED" not in r.stdout
    return wd


@pytest.mark.parametrize("resume_devices", [1, 8])
def test_crash_sigkill_resume_bit_identical(killed_child, resume_devices):
    """One SIGKILL/resume cycle through the lineage: the port's child dies
    at its SECOND commit, this process resumes from ``latest_valid()`` on 1
    or 8 slots, and the continued run's full state is bit-identical to the
    uninterrupted one — the port's and the JAX package's."""
    from dccrg_tpu.models import GameOfLife as JGameOfLife

    runs = {}
    for pkg, Model in ((dccrg_tpu_torch, GameOfLife), (dccrg_tpu, JGameOfLife)):
        g = (pkg.Grid().set_initial_length((6, 6, 1)).set_neighborhood_length(1)
             .set_periodic(True, True, False).initialize(**_mesh_kw(pkg, 1)))
        cells = g.get_cells()
        gol = Model(g)
        alive0 = cells[np.random.default_rng(0).random(len(cells)) < 0.4]
        ref = gol.run(gol.new_state(alive_cells=alive0), 8)
        runs[pkg.__name__] = {f: np.asarray(g.get_cell_data(ref, f, cells))
                              for f in GameOfLife.SPEC}
    g2, s2, hdr, gen = Grid.resume_latest(
        os.path.join(killed_child, "gol"), GameOfLife.SPEC,
        n_devices=resume_devices, device="cpu")
    assert int(hdr) == 2 and gen == 2     # died exactly at the second commit
    gol2 = GameOfLife(g2)
    s2 = gol2.run(s2, 8 - int(hdr))
    for f in GameOfLife.SPEC:
        got = g2.get_cell_data(s2, f, cells)
        np.testing.assert_array_equal(got, runs["dccrg_tpu_torch"][f], err_msg=f)
        np.testing.assert_array_equal(got, runs["dccrg_tpu"][f], err_msg=f)
