"""The Game of Life kernel's plain twin (the port's CPU path) against the JAX
package's Pallas kernel in interpret mode, on the same numpy boards, and the
port's copied dispatch thresholds against the JAX package's.

Tolerance: none — the count and the rule are exact (integers <= 8 in
float32), so the boards and counts must be equal element for element, with
and without the JAX kernel's tile padding (bit-identical by its contract).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dccrg_tpu.ops import gol_kernel as jgol
from dccrg_tpu.ops import vlasov_kernel as jvk
from dccrg_tpu_torch.ops import gol_kernel as tgol
from dccrg_tpu_torch.ops import vlasov_kernel as tvk
from dccrg_tpu_torch.ops import LAUNCHES, PLAIN_CALLS, reset_counts

NY, NX = 12, 20
PERIODIC = [(False, False), (True, False), (False, True), (True, True)]


def _board(seed=3, fill=0.35):
    rng = np.random.default_rng(seed)
    return (rng.random((NY, NX)) < fill).astype(np.float32)


@pytest.mark.parametrize("pad", [(None, None), (16, None), (None, 24), (16, 24)],
                         ids=["unpadded", "ypad", "xpad", "xypad"])
@pytest.mark.parametrize("px,py", PERIODIC)
def test_gol_twin_matches_pallas(px, py, pad):
    a = _board()
    run = jgol.make_gol_run(NY, NX, px, py, ny_pad=pad[0], nx_pad=pad[1],
                            interpret=True)
    for turns in (0, 4, 7):
        want_a, want_c = run(jnp.asarray(a), turns)
        calls = PLAIN_CALLS["gol_run"]
        got_a, got_c = tgol.gol_run(torch.from_numpy(a), turns, px, py)
        assert PLAIN_CALLS["gol_run"] == calls + 1
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_gol_twin_zero_turns_and_odd_counts():
    """turns == 0 returns the board and zero counts; an odd run ends on the
    board of its last turn, as one turn at a time does."""
    a = torch.from_numpy(_board(seed=5))
    out, cnt = tgol.gol_run_plain(a, 0, False, True)
    assert torch.equal(out, a) and not cnt.any()
    one = a
    for _ in range(3):
        one, c1 = tgol.gol_run_plain(one, 1, False, True)
    three, c3 = tgol.gol_run_plain(a, 3, False, True)
    assert torch.equal(one, three) and torch.equal(c1, c3)


@pytest.mark.parametrize("shape", [(10, 10), (500, 500), (4096, 3072),
                                   (4096, 3073), (2048, 6145)])
def test_gol_run_fits_matches_jax(shape):
    assert tgol.gol_run_fits(*shape) == jgol.gol_run_fits(*shape)


@pytest.mark.parametrize("shape", [(8, 8, 8, 64), (32, 32, 32, 512), (4, 8, 8, 64),
                                   (6, 16, 16, 27), (7, 8, 8, 64), (8, 128, 128, 512),
                                   (2, 64, 64, 512), (16, 256, 256, 512)])
def test_pick_vlasov_block_matches_jax(shape):
    assert tvk.pick_vlasov_block(*shape) == jvk.pick_vlasov_block(*shape)


def test_dispatch_thresholds_pinned():
    """The copied VMEM rules at the sizes that matter on the card: boards
    above 3 * 2^20 cells leave the whole-run kernel for the dense loop, and
    a 64^3 x 8^3 Vlasov slab gets no block, so it steps in plain torch
    (ROADMAP P4 queues the retune)."""
    assert tgol.gol_run_fits(500, 500)
    assert tgol.gol_run_fits(2048, 1536) and not tgol.gol_run_fits(2048, 1537)
    assert not tgol.gol_run_fits(2048, 2048)
    assert tvk.pick_vlasov_block(32, 32, 32, 512) == 4
    assert tvk.pick_vlasov_block(64, 64, 64, 512) == 0


def test_gol_cpu_wrapper_launches_nothing():
    """On a CPU tensor the wrapper runs the twin and counts no launch; a
    CPU/CUDA mix is refused."""
    reset_counts()
    tgol.gol_run(torch.from_numpy(_board()), 2, True, True)
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    assert PLAIN_CALLS["gol_run"] == 1
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tgol.gol_run(torch.empty((NY, NX), device="meta"), 1, True, True)
