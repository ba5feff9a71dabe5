"""Checkpoint I/O, the VTK writer and ``initialize(leaf_set=...)`` in the
port (tests/test_restart.py and tests/test_checkpoint_hardening.py
mirrored, on the CPU), plus the shared file format: a file either package
writes loads in the other, with payloads equal by cell id, and both write
the same VTK bytes.

Tolerances: payloads and structure exact (bytes); the restarted f64 gather
steps 1e-13 relative (test_restart.py's own).
"""
import os
import struct

import numpy as np
import pytest

import dccrg_tpu
import dccrg_tpu_torch
from dccrg_tpu_torch import CartesianGeometry, Grid
from dccrg_tpu_torch.io import checkpoint
from dccrg_tpu_torch.io.checkpoint import (
    CHECKPOINT_VERSION,
    COUNTS,
    V2_MAGIC,
    CheckpointError,
    quick_validate,
)
from dccrg_tpu_torch.models import Advection, GameOfLife, Particles
from dccrg_tpu_torch.resilience import inject

SPEC = {"a": ((), np.float64), "b": ((3,), np.float32)}


def _mesh_kw(pkg, n_dev):
    return ({"mesh": dccrg_tpu.make_mesh(n_devices=n_dev)} if pkg is dccrg_tpu
            else {"n_devices": n_dev, "device": "cpu"})


def _grid_and_state(n_devices=2, seed=7, pkg=dccrg_tpu_torch):
    """test_checkpoint_hardening.py's grid: 4x4x2, one cell refined, random
    payloads of SPEC."""
    g = (pkg.Grid().set_initial_length((4, 4, 2))
         .set_maximum_refinement_level(1).set_neighborhood_length(1)
         .set_periodic(True, False, False)
         .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(0.25, 0.25, 0.5))
         .initialize(**_mesh_kw(pkg, n_devices)))
    g.refine_completely(1)
    g.stop_refining()
    cells = g.get_cells()
    rng = np.random.default_rng(seed)
    av = rng.standard_normal(len(cells))
    bv = rng.standard_normal((len(cells), 3)).astype(np.float32)
    state = g.set_cell_data(g.new_state(SPEC), "a", cells, av)
    state = g.set_cell_data(state, "b", cells, bv)
    return g, state, cells, av, bv


def _sections_of(raw: bytes):
    """Byte extents of each v2 section: [(name, start, end), ...]."""
    assert raw[:8] == V2_MAGIC
    (hlen,) = struct.unpack("<Q", raw[8:16])
    (n_cells,) = struct.unpack("<Q", raw[16 + hlen - 8:16 + hlen])
    head_end = 16 + hlen + 4
    tlen = n_cells * 20 + 8
    table_end = head_end + tlen + 4
    return [("magic", 0, 8), ("header_len", 8, 16), ("header", 16, 16 + hlen),
            ("header_crc", 16 + hlen, head_end),
            ("cell_table", head_end, head_end + tlen),
            ("table_crc", head_end + tlen, table_end),
            ("payload", table_end, len(raw))]


def _load(path, spec, n_dev, **kw):
    return Grid.load_grid_data(path, spec, n_devices=n_dev, device="cpu", **kw)


# ------------------------------------------------ tests/test_restart.py


def test_save_load_structure_and_data(tmp_path):
    g = (Grid().set_initial_length((4, 4, 2)).set_maximum_refinement_level(1)
         .set_neighborhood_length(1).set_periodic(True, False, False)
         .set_geometry(CartesianGeometry, start=(1.0, 2.0, 3.0),
                       level_0_cell_length=(0.5, 0.5, 2.0))
         .initialize(device="cpu"))
    g.refine_completely(1)
    g.refine_completely(30)
    g.stop_refining()
    cells = g.get_cells()
    rng = np.random.default_rng(5)
    av = rng.standard_normal(len(cells))
    bv = rng.standard_normal((len(cells), 3)).astype(np.float32)
    state = g.set_cell_data(g.new_state(SPEC), "a", cells, av)
    state = g.set_cell_data(state, "b", cells, bv)
    path = tmp_path / "ckpt.dc"
    g.save_grid_data(state, str(path), SPEC, user_header=b"hello-restart")
    for n_dev in (8, 3, 1):
        g2, s2, hdr = _load(str(path), SPEC, n_dev)
        assert hdr == b"hello-restart"
        np.testing.assert_array_equal(g2.get_cells(), cells)
        assert g2.mapping == g.mapping and g2.topology == g.topology
        np.testing.assert_allclose(g2.geometry.get_center(cells),
                                   g.geometry.get_center(cells))
        np.testing.assert_array_equal(g2.get_cell_data(s2, "a", cells), av)
        np.testing.assert_array_equal(g2.get_cell_data(s2, "b", cells), bv)


def test_restarted_gol_matches_uninterrupted(tmp_path):
    def build():
        g = (Grid().set_initial_length((10, 10, 1)).set_neighborhood_length(1)
             .initialize(device="cpu"))
        return g, GameOfLife(g)

    alive0 = [54, 55, 56, 12, 13, 22, 77]
    g1, gol1 = build()
    want = set(gol1.alive_cells(gol1.run(gol1.new_state(alive_cells=alive0), 10)).tolist())
    g2, gol2 = build()
    s2 = gol2.run(gol2.new_state(alive_cells=alive0), 4)
    path = tmp_path / "gol.dc"
    g2.save_grid_data(s2, str(path), GameOfLife.SPEC)
    g3, s3, _ = _load(str(path), GameOfLife.SPEC, 3)
    gol3 = GameOfLife(g3)
    assert set(gol3.alive_cells(gol3.run(s3, 6)).tolist()) == want


def test_vtk_writer(tmp_path):
    g = (Grid().set_initial_length((2, 2, 1)).set_maximum_refinement_level(1)
         .initialize(device="cpu"))
    g.refine_completely(1)
    g.stop_refining()
    n = len(g.get_cells())
    rho = np.arange(n)
    path = tmp_path / "grid.vtk"
    g.write_vtk_file(str(path), scalars={"rho": rho}, binary=False)
    text = path.read_text()
    assert "UNSTRUCTURED_GRID" in text and f"CELLS {n} {9 * n}" in text
    assert "SCALARS rho" in text
    pb = tmp_path / "grid_bin.vtk"
    g.write_vtk_file(str(pb), scalars={"rho": rho})
    raw = pb.read_bytes()
    assert b"BINARY" in raw and f"CELLS {n} {9 * n}".encode() in raw
    pts_off = raw.index(b"float\n") + len(b"float\n")
    pts = np.frombuffer(raw[pts_off:pts_off + 8 * n * 3 * 4], ">f4")
    np.testing.assert_allclose(pts.reshape(n, 8, 3)[:, 0],
                               g.geometry.get_min(g.get_cells()), rtol=1e-6)
    sc_off = raw.index(b"LOOKUP_TABLE default\n") + len(b"LOOKUP_TABLE default\n")
    np.testing.assert_allclose(np.frombuffer(raw[sc_off:sc_off + 4 * n], ">f4"),
                               rho.astype(np.float32))


def _particle_grid(pkg, n_dev):
    return (pkg.Grid().set_initial_length((4, 4, 1)).set_neighborhood_length(1)
            .set_periodic(True, True, False)
            .set_geometry(pkg.CartesianGeometry, start=(0.0, 0.0, 0.0),
                          level_0_cell_length=(0.25, 0.25, 1.0))
            .initialize(**_mesh_kw(pkg, n_dev)))


def test_variable_size_payload_roundtrip(tmp_path):
    """Ragged fields store only count[i] rows per cell."""
    g = _particle_grid(dccrg_tpu_torch, 4)
    p = Particles(g, max_particles_per_cell=8)
    rng = np.random.default_rng(11)
    state = p.new_state(rng.uniform(0.01, 0.99, size=(37, 3)))
    spec, ragged = p.spec(), {"particles": "number_of_particles"}
    path, path_full = tmp_path / "ragged.dc", tmp_path / "full.dc"
    g.save_grid_data(state, str(path), spec, ragged=ragged)
    g.save_grid_data(state, str(path_full), spec)
    assert path.stat().st_size < path_full.stat().st_size
    for n_dev in (2, 8):
        g2, s2, _ = _load(str(path), spec, n_dev, ragged=ragged)
        p2 = Particles(g2, max_particles_per_cell=8)
        np.testing.assert_array_equal(
            np.sort(p2.positions(s2).view("f4,f4,f4"), axis=0),
            np.sort(p.positions(state).view("f4,f4,f4"), axis=0))
        for c in g.get_cells():
            np.testing.assert_array_equal(np.sort(p2.particles_of(s2, c), axis=0),
                                          np.sort(p.particles_of(state, c), axis=0))


def test_chunked_loading(tmp_path):
    g = (Grid().set_initial_length((6, 6, 1)).set_neighborhood_length(1)
         .initialize(device="cpu"))
    spec = {"v": ((2,), np.float64)}
    cells = g.get_cells()
    vals = np.arange(2 * len(cells), dtype=np.float64).reshape(len(cells), 2)
    state = g.set_cell_data(g.new_state(spec), "v", cells, vals)
    path = tmp_path / "chunk.dc"
    g.save_grid_data(state, str(path), spec, user_header=b"chunked")
    loader = Grid.start_loading_grid_data(str(path), spec, n_devices=3, device="cpu")
    n_calls = 0
    while loader.continue_loading_grid_data(max_cells=7):
        n_calls += 1
    g2, s2, hdr = loader.finish_loading_grid_data()
    assert n_calls >= 5 and hdr == b"chunked"
    np.testing.assert_array_equal(g2.get_cell_data(s2, "v", cells), vals)
    assert s2["v"].device.type == "cpu"


@pytest.mark.parametrize("seed", [3, 11])
def test_fuzz_checkpoint_roundtrip_random_grids(seed, tmp_path):
    """A random multi-level grid saved on one slot count and reloaded on
    another: structure and payloads bitwise, and the gather steps in
    lockstep with the original."""
    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 6]))
    nd_a, nd_b = int(rng.choice([1, 2, 4])), int(rng.choice([1, 3, 8]))
    periodic = tuple(bool(b) for b in rng.integers(0, 2, 3))
    max_lvl = int(rng.choice([1, 2]))
    g = (Grid().set_initial_length((n, n, n)).set_neighborhood_length(0)
         .set_periodic(*periodic).set_maximum_refinement_level(max_lvl)
         .set_geometry(CartesianGeometry, start=(0.0, 0.0, 0.0),
                       level_0_cell_length=(1.0 / n,) * 3)
         .initialize(n_devices=nd_a, device="cpu"))
    for _ in range(max_lvl):
        ids = g.get_cells()
        g.refine_completely_many(rng.choice(ids, size=max(1, len(ids) // 5), replace=False))
        g.stop_refining()
    ids = g.get_cells()
    adv = Advection(g)
    s = adv.initialize_state()
    s = adv.set_cell_data(s, "density", ids, rng.uniform(1, 2, len(ids)))
    for f in ("vx", "vy", "vz"):
        s = adv.set_cell_data(s, f, ids, rng.uniform(-0.2, 0.2, len(ids)))
    s = g.update_copies_of_remote_neighbors(s)
    spec = {k: adv.spec[k] for k in ("density", "vx", "vy", "vz")}
    path = str(tmp_path / "f.dc")
    g.save_grid_data(s, path, spec)
    g2, s2, _ = _load(path, spec, nd_b)
    np.testing.assert_array_equal(g2.get_cells(), ids)
    for f in spec:
        np.testing.assert_array_equal(g2.get_cell_data(s2, f, ids), g.get_cell_data(s, f, ids))
    adv2 = Advection(g2)
    full2 = adv2.initialize_state()
    for f in spec:
        full2 = adv2.set_cell_data(full2, f, ids, g2.get_cell_data(s2, f, ids))
    full2 = g2.update_copies_of_remote_neighbors(full2)
    dt = 0.3 * adv.max_time_step(s)
    a, b = s, full2
    for _ in range(2):
        a, b = adv.step(a, dt), adv2.step(b, dt)
    np.testing.assert_allclose(adv.get_cell_data(a, "density", ids),
                               adv2.get_cell_data(b, "density", ids), rtol=1e-13, atol=0)


def _leaf_cases(pkg):
    """test_restart.py::test_leaf_set_initialize_validates's sets: (valid
    set, {match: corrupt set})."""
    m = pkg.Grid().set_initial_length((4, 4, 4)).set_maximum_refinement_level(2)
    m = m.initialize(**_mesh_kw(pkg, 1)).mapping
    base = np.arange(1, 65, dtype=np.uint64)
    kids = m.get_all_children(np.uint64(1))
    grandkids = np.concatenate([m.get_all_children(k) for k in kids])
    kids2 = m.get_all_children(np.uint64(2))
    gkids = m.get_all_children(kids2[0])
    bad = {
        "duplicate": np.concatenate([base, base[:1]]),
        "tile": base[1:],
        "2:1|consistent": np.concatenate([base[1:], grandkids]),
        "ancestor": np.concatenate([base[0:1], base[2:], kids]),
        "consistent": np.concatenate([base[:1], base[2:], kids2[1:], gkids]),
    }
    ok = np.concatenate([base[1:], kids])
    return ok.astype(np.uint64), {k: v.astype(np.uint64) for k, v in bad.items()}


@pytest.mark.parametrize("pkg", [dccrg_tpu_torch, dccrg_tpu], ids=["port", "jax"])
def test_leaf_set_initialize_validates(pkg):
    """Direct leaf-set construction rejects corrupt sets (duplicates, holes,
    2:1 violations, a cell with its ancestor, a deep inconsistency) in both
    packages alike; a valid set builds."""
    def fresh():
        return (pkg.Grid().set_initial_length((4, 4, 4))
                .set_maximum_refinement_level(2).set_neighborhood_length(1))

    ok, bad = _leaf_cases(pkg)
    assert len(fresh().initialize(leaf_set=ok, **_mesh_kw(pkg, 1)).get_cells()) == 71
    for match, cells in bad.items():
        with pytest.raises(ValueError, match=match):
            fresh().initialize(leaf_set=cells, **_mesh_kw(pkg, 1))


# ------------------------------------- tests/test_checkpoint_hardening.py


def test_v2_is_default_and_roundtrips(tmp_path):
    g, state, cells, av, bv = _grid_and_state()
    path = str(tmp_path / "v2.dc")
    g.save_grid_data(state, path, SPEC, user_header=b"v2-header")
    assert open(path, "rb").read()[:8] == V2_MAGIC
    assert CHECKPOINT_VERSION == 2 and quick_validate(path) == 2
    assert not os.path.exists(path + ".tmp")
    for n_dev in (1, 3, 8):
        g2, s2, hdr = _load(path, SPEC, n_dev)
        assert hdr == b"v2-header"
        np.testing.assert_array_equal(g2.get_cells(), cells)
        np.testing.assert_array_equal(g2.get_cell_data(s2, "a", cells), av)
        np.testing.assert_array_equal(g2.get_cell_data(s2, "b", cells), bv)


def test_v1_files_still_load(tmp_path):
    g, state, cells, av, bv = _grid_and_state()
    path = str(tmp_path / "v1.dc")
    g.save_grid_data(state, path, SPEC, user_header=b"old", version=1)
    assert open(path, "rb").read()[:8] != V2_MAGIC
    assert quick_validate(path) == 1
    g2, s2, hdr = _load(path, SPEC, 3)
    assert hdr == b"old"
    np.testing.assert_array_equal(g2.get_cell_data(s2, "a", cells), av)
    np.testing.assert_array_equal(g2.get_cell_data(s2, "b", cells), bv)


@pytest.mark.parametrize("version", [1, 2])
def test_truncation_raises_typed_error_at_every_cut(tmp_path, version):
    """A file cut anywhere raises CheckpointError naming a section, one-shot
    and chunked alike."""
    g, state, cells, av, bv = _grid_and_state(n_devices=1)
    path = str(tmp_path / "full.dc")
    g.save_grid_data(state, path, SPEC, version=version)
    raw = open(path, "rb").read()
    cuts = set()
    if version == 2:
        for _, start, end in _sections_of(raw):
            cuts.update((start, (start + end) // 2, max(start, end - 1)))
    cuts.update(range(0, len(raw), max(1, len(raw) // 40)))
    cuts.discard(len(raw))
    cut_path = str(tmp_path / "cut.dc")
    for cut in sorted(cuts):
        with open(cut_path, "wb") as f:
            f.write(raw[:cut])
        with pytest.raises(CheckpointError) as ei:
            _load(cut_path, SPEC, 1)
        assert ei.value.section, cut
        with pytest.raises(CheckpointError):
            loader = Grid.start_loading_grid_data(cut_path, SPEC, n_devices=1, device="cpu")
            while loader.continue_loading_grid_data(max_cells=3):
                pass
            loader.finish_loading_grid_data()


def test_bit_flip_detected_per_section(tmp_path):
    """One flipped bit in any section is detected by that section's CRC,
    reported with its name and counted."""
    g, state, cells, av, bv = _grid_and_state(n_devices=1)
    path = str(tmp_path / "clean.dc")
    g.save_grid_data(state, path, SPEC)
    raw = open(path, "rb").read()
    sections = {name: (s, e) for name, s, e in _sections_of(raw)}
    flip_path = str(tmp_path / "flipped.dc")
    for name in ("header", "cell_table", "payload"):
        start, end = sections[name]
        flipped = bytearray(raw)
        flipped[(start + end) // 2] ^= 0x20
        open(flip_path, "wb").write(bytes(flipped))
        before = COUNTS["crc_failures." + name]
        with pytest.raises(CheckpointError) as ei:
            _load(flip_path, SPEC, 1)
        assert ei.value.section == name
        assert COUNTS["crc_failures." + name] > before


def test_salvage_recovers_every_intact_cell(tmp_path):
    g, state, cells, av, bv = _grid_and_state(n_devices=2)
    path = str(tmp_path / "clean.dc")
    g.save_grid_data(state, path, SPEC)
    raw = bytearray(open(path, "rb").read())
    payload_start = _sections_of(bytes(raw))[-1][1]
    bpc = 8 + 3 * 4
    victims = [1, len(cells) // 2, len(cells) - 1]
    for v in victims:
        raw[payload_start + v * bpc + 3] ^= 0xFF
    bad_path = str(tmp_path / "bad.dc")
    open(bad_path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointError, match="payload"):
        _load(bad_path, SPEC, 1)
    before_lost = COUNTS["cells_lost"]
    g2, s2, hdr, lost = _load(bad_path, SPEC, 3, on_error="salvage")
    np.testing.assert_array_equal(lost, cells[np.asarray(victims)])
    keep = ~np.isin(cells, lost)
    np.testing.assert_array_equal(g2.get_cell_data(s2, "a", cells[keep]), av[keep])
    np.testing.assert_array_equal(g2.get_cell_data(s2, "b", cells[keep]), bv[keep])
    np.testing.assert_array_equal(g2.get_cell_data(s2, "a", lost), np.zeros(len(lost)))
    assert COUNTS["cells_lost"] == before_lost + len(victims)


def test_salvage_of_truncated_file_recovers_prefix(tmp_path):
    g, state, cells, av, bv = _grid_and_state(n_devices=1)
    path = str(tmp_path / "clean.dc")
    g.save_grid_data(state, path, SPEC)
    raw = open(path, "rb").read()
    payload_start = _sections_of(raw)[-1][1]
    bpc = 8 + 3 * 4
    keep_cells = len(cells) // 3
    cut_path = str(tmp_path / "torn.dc")
    open(cut_path, "wb").write(raw[:payload_start + keep_cells * bpc + bpc // 2])
    with pytest.raises(CheckpointError, match="truncated"):
        _load(cut_path, SPEC, 1)
    g2, s2, hdr, lost = _load(cut_path, SPEC, 1, on_error="salvage")
    np.testing.assert_array_equal(lost, cells[keep_cells:])
    np.testing.assert_array_equal(g2.get_cell_data(s2, "a", cells[:keep_cells]),
                                  av[:keep_cells])


def test_salvage_ragged_payloads(tmp_path):
    """A corrupt ragged cell is lost alone; every other cell's particles
    survive bit-exactly."""
    g = _particle_grid(dccrg_tpu_torch, 4)
    p = Particles(g, max_particles_per_cell=8)
    state = p.new_state(np.random.default_rng(3).uniform(0.01, 0.99, size=(41, 3)))
    spec, ragged = p.spec(), {"particles": "number_of_particles"}
    path = str(tmp_path / "ragged.dc")
    g.save_grid_data(state, path, spec, ragged=ragged)
    raw = bytearray(open(path, "rb").read())
    cells = g.get_cells()
    secs = {n: (s, e) for n, s, e in _sections_of(bytes(raw))}
    t0 = secs["cell_table"][0]
    n = len(cells)
    table = np.frombuffer(bytes(raw[t0:t0 + n * 16]), "<u8").reshape(n, 2)
    counts = np.asarray(g.get_cell_data(state, "number_of_particles", table[:, 0]), np.int64)
    victim = int(np.flatnonzero(counts > 0)[0])
    raw[secs["payload"][0] + int(table[victim, 1]) + 10] ^= 0x40
    bad = str(tmp_path / "ragged_bad.dc")
    open(bad, "wb").write(bytes(raw))
    g2, s2, hdr, lost = _load(bad, spec, 2, ragged=ragged, on_error="salvage")
    np.testing.assert_array_equal(lost, table[victim:victim + 1, 0])
    p2 = Particles(g2, max_particles_per_cell=8)
    for c in cells:
        if c == lost[0]:
            assert len(p2.particles_of(s2, int(c))) == 0
        else:
            np.testing.assert_array_equal(np.sort(p2.particles_of(s2, int(c)), axis=0),
                                          np.sort(p.particles_of(state, int(c)), axis=0))


def test_quick_validate_failures(tmp_path):
    g, state, cells, av, bv = _grid_and_state(n_devices=1)
    path = str(tmp_path / "c.dc")
    g.save_grid_data(state, path, SPEC)
    raw = open(path, "rb").read()
    bad = str(tmp_path / "bad.dc")
    open(bad, "wb").write(raw[:-7])
    with pytest.raises(CheckpointError, match="payload"):
        quick_validate(bad)
    secs = {n: (s, e) for n, s, e in _sections_of(raw)}
    flipped = bytearray(raw)
    flipped[(secs["header"][0] + secs["header"][1]) // 2] ^= 1
    open(bad, "wb").write(bytes(flipped))
    with pytest.raises(CheckpointError, match="header"):
        quick_validate(bad)
    flipped = bytearray(raw)
    flipped[-3] ^= 1
    open(bad, "wb").write(bytes(flipped))
    assert quick_validate(bad) == 2


def test_on_error_rejects_unknown_policy(tmp_path):
    g, state, cells, av, bv = _grid_and_state(n_devices=1)
    path = str(tmp_path / "c.dc")
    g.save_grid_data(state, path, SPEC)
    with pytest.raises(ValueError, match="on_error"):
        _load(path, SPEC, 1, on_error="ignore")
    with pytest.raises(ValueError, match="version"):
        g.save_grid_data(state, path, SPEC, version=3)


def test_checkpoint_error_is_value_error():
    err = CheckpointError("payload", "boom", path="/x")
    assert isinstance(err, ValueError) and err.section == "payload"
    assert "payload" in str(err) and "/x" in str(err)


# ------------------------------------------------- the fault seams


@pytest.mark.parametrize("site,section", [("checkpoint.bit_flip", "payload"),
                                          ("checkpoint.torn_write", None)])
def test_fault_seams_are_detected(tmp_path, site, section):
    """An armed write-time fault (a flipped payload bit, a torn file) is
    counted and the load refuses the file with a typed error."""
    g, state, cells, av, bv = _grid_and_state(n_devices=1)
    path = str(tmp_path / "f.dc")
    before = inject.COUNTS["injected." + site]
    inject.plane.arm(site, prob=1.0, seed=5, count=1)
    try:
        g.save_grid_data(state, path, SPEC)
    finally:
        inject.plane.disarm(site)
    assert inject.COUNTS["injected." + site] == before + 1
    with pytest.raises(CheckpointError) as ei:
        _load(path, SPEC, 1)
    if section:
        assert ei.value.section == section
    g.save_grid_data(state, path, SPEC)          # disarmed: clean again
    np.testing.assert_array_equal(_load(path, SPEC, 1)[0].get_cells(), cells)


# ------------------------------------------- one format for both packages


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_files_cross_between_packages(tmp_path, n_dev, version):
    """A file the JAX package writes loads in the port and the other way
    round, on 1, 3 and 8 slots, with payloads equal by cell id; both
    packages write the same bytes for the same grid and state."""
    jg, js, cells, av, bv = _grid_and_state(n_devices=2, pkg=dccrg_tpu)
    pg, ps, pcells, _, _ = _grid_and_state(n_devices=2)
    np.testing.assert_array_equal(cells, pcells)
    jpath, ppath = str(tmp_path / "jax.dc"), str(tmp_path / "port.dc")
    jg.save_grid_data(js, jpath, SPEC, user_header=b"x", version=version)
    pg.save_grid_data(ps, ppath, SPEC, user_header=b"x", version=version)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    g2, s2, hdr = _load(jpath, SPEC, n_dev)
    j2, t2, jhdr = dccrg_tpu.Grid.load_grid_data(ppath, SPEC,
                                                 mesh=dccrg_tpu.make_mesh(n_devices=n_dev))
    assert hdr == jhdr == b"x"
    np.testing.assert_array_equal(g2.get_cells(), cells)
    np.testing.assert_array_equal(j2.get_cells(), cells)
    np.testing.assert_array_equal(g2.leaves.owner, j2.leaves.owner)
    for name, want in (("a", av), ("b", bv)):
        np.testing.assert_array_equal(g2.get_cell_data(s2, name, cells), want)
        np.testing.assert_array_equal(np.asarray(j2.get_cell_data(t2, name, cells)), want)


def test_advection_state_crosses_and_steps_alike(tmp_path):
    """A refined f64 advection state saved by the JAX package reloads in the
    port on 8 slots, and the port's gather steps from it equal the JAX
    package's (1e-12, test_torch_advection_amr.py's)."""
    from dccrg_tpu.models import Advection as JAdvection

    jg = (dccrg_tpu.Grid().set_initial_length((6, 6, 6)).set_neighborhood_length(0)
          .set_periodic(True, True, True).set_maximum_refinement_level(1)
          .set_geometry(dccrg_tpu.CartesianGeometry, start=(0.0, 0.0, 0.0),
                        level_0_cell_length=(1 / 6,) * 3)
          .initialize(mesh=dccrg_tpu.make_mesh(n_devices=2)))
    ids = jg.get_cells()
    jg.refine_completely_many(ids[np.linalg.norm(jg.geometry.get_center(ids) - 0.5, axis=1) < 0.3])
    jg.stop_refining()
    ja = JAdvection(jg, dtype=np.float64, use_pallas=False, allow_boxed=False)
    js = ja.initialize_state()
    path = str(tmp_path / "adv.dc")
    jg.save_grid_data(js, path, ja.spec)
    pg, ps, _ = _load(path, ja.spec, 8)
    pa = Advection(pg, dtype=np.float64, use_kernels=False)
    ps = pg.update_copies_of_remote_neighbors(ps)
    dt = 0.3 * ja.max_time_step(js)
    for _ in range(3):
        js, ps = ja.step(js, dt), pa.step(ps, dt)
    cells = jg.get_cells()
    np.testing.assert_allclose(pa.get_cell_data(ps, "density", cells),
                               np.asarray(ja.get_cell_data(js, "density", cells)), rtol=1e-12)


@pytest.mark.parametrize("binary", [True, False])
def test_vtk_bytes_equal_jax(tmp_path, binary):
    """The port's VTK file is the JAX package's byte for byte, for the same
    refined grid and scalars."""
    out = []
    for pkg in (dccrg_tpu, dccrg_tpu_torch):
        g = (pkg.Grid().set_initial_length((4, 3, 2)).set_maximum_refinement_level(1)
             .set_geometry(pkg.CartesianGeometry, start=(0.5, -1.0, 2.0),
                           level_0_cell_length=(0.3, 0.7, 1.1))
             .initialize(**_mesh_kw(pkg, 2)))
        g.refine_completely(5)
        g.stop_refining()
        ids = g.get_cells()
        path = tmp_path / f"{pkg.__name__}.vtk"
        g.write_vtk_file(str(path), scalars={"rho": np.sin(ids.astype(np.float64)),
                                             "lvl": g.mapping.get_refinement_level(ids)},
                         binary=binary)
        out.append(path.read_bytes())
    assert out[0] == out[1]


def test_counters(tmp_path):
    """``checkpoint.COUNTS`` counts what a save writes and a load reads."""
    g, state, cells, av, bv = _grid_and_state(n_devices=1)
    before = dict(checkpoint.COUNTS)
    path = str(tmp_path / "c.dc")
    g.save_grid_data(state, path, SPEC)
    assert COUNTS["cells_written"] - before.get("cells_written", 0) == len(cells)
    assert (COUNTS["bytes_written"] - before.get("bytes_written", 0)
            == len(cells) * (8 + 12 + 16))
    _load(path, SPEC, 1)
    assert COUNTS["cells_read"] - before.get("cells_read", 0) == len(cells)
    assert COUNTS["bytes_read"] - before.get("bytes_read", 0) == len(cells) * 20
