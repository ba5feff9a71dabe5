"""The frozen work counts against hand counts on 4^3 grids."""
import pytest

from portbench import load
from portbench.reference.advection import Reference
from portbench.work import advection as work


def _ref(tiny, ball=None):
    cfg = load.config("adv_amr_48", tiny)
    cfg["initial_length"] = [4, 4, 4]
    cfg.pop("adapt")
    cfg["max_refinement_level"] = 1 if ball else 0
    cfg["refine"] = [ball] if ball else []
    return Reference(cfg)


def test_uniform_4cubed(tiny):
    """64 cells, 3 faces each on a periodic grid: 192 faces, 11 operations a
    cell-step; 4 fields read and 1 written, 4 bytes each, once a call."""
    s = _ref(tiny).summary("cpu")
    assert s == {"leaves": 64, "faces": 192}
    assert work.call(64, 192, 10, 4) == pytest.approx((11 * 64 * 10, 5 * 4 * 64))
    run = work.chunk_calls({"entry": "run", "k": 7}, s, 4)
    step = work.chunk_calls({"entry": "step", "k": 7}, s, 4)
    assert run == [pytest.approx((11 * 64 * 7, 320 * 4))]
    assert step == [pytest.approx((11 * 64, 320 * 4))] * 7


def test_two_level_4cubed(tiny):
    """Cell (0, 0, 0) refined: 63 + 8 = 71 leaves; faces 192 - 6 coarse
    faces + 6 x 4 coarse-fine faces + 12 faces inside the refined cell = 222."""
    s = _ref(tiny, {"centre": [0.125, 0.125, 0.125], "radius": 0.01}).summary("cpu")
    assert s == {"leaves": 71, "faces": 222}
    ops, moved = work.call(71, 222, 1, 4)
    assert ops == pytest.approx(11 / 3 * 222) and moved == 5 * 4 * 71


def test_least_seconds_names_the_binding_bound():
    t, binds = work.least_seconds([(67e12, 1.0)], 67e12, 3.35e12)
    assert t == pytest.approx(1.0) and binds == "operations"
    t, binds = work.least_seconds([(1.0, 3.35e12)] * 2, 67e12, 3.35e12)
    assert t == pytest.approx(2.0) and binds == "bytes"
