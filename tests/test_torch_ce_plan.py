"""weighted_ce's launch plan (``ops/weighted_ce.py:launch_plan``) at 13, 15,
19 and 32 classes over a train batch (16 x 512²), the CPU tests' size
(4 x 64²) and a prime pixel count; what the wrappers tell the C entry
points; the phases tool's source variants; and the plain versions against
``flairtpu``'s loss, its ``jax.grad`` and its confusion matrix at 13, 15
and 19 classes on block-constant targets with a tie. Pure Python apart from
a few small JAX calls: the kernels run only on a card, where
``chip_smoke.py`` holds them against their plain versions.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flairtpu.ops.confmat import confusion_matrix
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch.ops import weighted_ce as wc
from flairtpu_torch.ops import weighted_ce_phases

SOURCE = Path(wc.__file__).resolve().parent.parent / "csrc" / "weighted_ce.cu"
CLASSES = (13, 15, 19, 32)
PIXELS = {"train": 16 * 512 * 512, "cpu": 4 * 64 * 64, "prime": 1_000_003}
# co-resident grids: 132 SMs x 1, 2, 3, 4 and 8 blocks
CO_RESIDENT = (132, 264, 396, 528, 1056)
SHARED_BYTES = 232448  # the shared memory a block can use on Hopper (227 KB)
# the kernels' static shared memory, at most (the forward's): the K x K
# counts, the weights, the block's float and double sums, the last-block
# flag and a barrier a stage, with room for alignment
STATIC_SHARED_BYTES = (4 * wc.MAX_CLASSES ** 2 + 4 * wc.MAX_CLASSES + 4 * 16 + 8 * 16 + 4
                       + 8 * wc.STAGES["forward"] + 256)


def test_plan_constants_match_the_kernel_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == wc.THREADS
    assert const("kTile") == wc.TILE
    assert const("kMaxClasses") == wc.MAX_CLASSES
    assert const("kForwardStages") == wc.STAGES["forward"]
    assert const("kBackwardStages") == wc.STAGES["backward"]
    assert const("kCounterWords") == wc.COUNTER_WORDS


@pytest.mark.parametrize("size", PIXELS)
@pytest.mark.parametrize("k", CLASSES)
def test_launch_plan(k, size):
    """The grid never exceeds the co-resident blocks or the tiles; the
    blocks' tiles cover every pixel exactly once; each bulk copy's offset
    and size are multiples of 16 bytes and lie inside the tensors; the
    ragged last tile and every tile of an unaligned call take the 4-byte
    path; the ring fits in a block's shared memory; the forward's scratch
    holds the ticket and a pair a block."""
    n = PIXELS[size]
    for mode in ("forward", "backward"):
        for co in CO_RESIDENT:
            for aligned in (True, False):
                plan = wc.launch_plan(n, k, mode, co, aligned)
                assert 1 <= plan.grid <= min(co, plan.tiles)
                assert (plan.tiles - 1) * wc.TILE < n <= plan.tiles * wc.TILE
                # the kernel's walk: block b takes tiles b, b + grid, ...
                mine = [(plan.tiles - 1 - b) // plan.grid + 1 for b in range(plan.grid)]
                tiles = np.concatenate([b + plan.grid * np.arange(m)
                                        for b, m in enumerate(mine)])
                assert np.array_equal(np.sort(tiles), np.arange(plan.tiles))
                starts = tiles * wc.TILE
                sizes = np.minimum(wc.TILE, n - starts)
                assert (sizes > 0).all() and sizes.sum() == n
                bulk = tiles[tiles < plan.bulk_tiles]
                if not aligned:
                    assert plan.bulk_tiles == 0
                else:
                    assert plan.bulk_tiles == n // wc.TILE
                    assert (plan.bulk_tiles == plan.tiles) == (n % wc.TILE == 0)
                assert ((bulk + 1) * wc.TILE <= n).all()  # whole tiles only
                for offset, nbytes in ((bulk * wc.TILE * k * 4, wc.TILE * k * 4),
                                       (bulk * wc.TILE * 4, wc.TILE * 4)):
                    assert (offset % 16 == 0).all() and nbytes % 16 == 0
                assert plan.stage_bytes == wc.TILE * (k + 1) * 4
                assert plan.stage_bytes % 16 == 0 and (wc.TILE * k * 4) % 16 == 0
                assert plan.ring_bytes == wc.STAGES[mode] * plan.stage_bytes
                assert plan.ring_bytes + STATIC_SHARED_BYTES <= SHARED_BYTES
                want = wc.COUNTER_WORDS + 2 * plan.grid if mode == "forward" else 0
                assert plan.scratch_words == want
    assert wc.COUNTER_WORDS * 4 % 16 == 0  # the partials start 16-byte aligned


def test_small_call_takes_one_block():
    assert wc.launch_plan(1, 19, "forward", 396) == wc.Plan(1, 1, 0, 20480, 61440,
                                                             wc.COUNTER_WORDS + 2)
    assert wc.launch_plan(wc.TILE, 2, "backward", 264).grid == 1


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card path on CPU tensors, their C entry points
    recorded: (symbol, args) a call."""
    calls = []

    def entry(name, argtypes, symbol=None):
        assert name == "weighted_ce" and len(argtypes) == {
            "weighted_ce_forward": len(wc.FORWARD_ARGTYPES),
            "weighted_ce_backward": len(wc.BACKWARD_ARGTYPES)}[symbol]
        return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(wc, "_on_card", lambda logits: True)
    monkeypatch.setattr(wc, "_co_resident",
                        lambda device, mode, k: {"forward": 396, "backward": 264}[mode])
    monkeypatch.setattr(wc, "_SCRATCH", {})
    monkeypatch.setattr(wc, "launches", 0)
    monkeypatch.setattr(wc, "backward_launches", 0)
    monkeypatch.setattr(wc._build, "entry", entry)
    monkeypatch.setattr(wc._build, "stream_handle", lambda t: 7)
    return calls


@pytest.mark.parametrize("shape,k", [((16, 512, 512), 19), ((4, 64, 64), 13),
                                     ((3, 37, 41), 32), ((1, 1, 5), 15)], ids=str)
def test_wrappers_tell_the_entry_points_the_plan(fake_card, shape, k):
    """Each call launches once with the plan's grid; the forward hands its
    stream's one cached scratch (a zero ticket, room for a pair a block) as
    the partials, the backward a fresh gradient."""
    n = int(np.prod(shape))
    logits = torch.zeros((*shape, k))
    tgt = torch.zeros(shape, dtype=torch.int32)
    w = torch.ones(k)
    cm = torch.zeros((k, k), dtype=torch.int32)
    loss, w_sum = wc.weighted_ce(logits, tgt, w, cm)
    wc.weighted_ce(logits, tgt, w, None)
    d = wc.weighted_ce_grad(logits, tgt, w, w_sum, torch.tensor(1.0))
    assert wc.launches == 2 and wc.backward_launches == 1
    (f_sym, f), (f2_sym, f2), (b_sym, b) = fake_card
    assert (f_sym, f2_sym, b_sym) == ("weighted_ce_forward",) * 2 + ("weighted_ce_backward",)
    fwd, back = wc.launch_plan(n, k, "forward", 396), wc.launch_plan(n, k, "backward", 264)
    scratch = wc._SCRATCH[(None, 7)]
    assert list(wc._SCRATCH) == [(None, 7)]
    assert scratch.dtype == torch.int32 and scratch.numel() >= fwd.scratch_words
    assert not scratch.any()  # the ticket starts at 0; the kernel leaves it so
    # forward: logits, target, weight, cm, partials, blocks, out, n, k, stream
    assert f[:4] == (logits.data_ptr(), tgt.data_ptr(), w.data_ptr(), cm.data_ptr())
    assert (f[4], f[5], f[7], f[8], f[9]) == (scratch.data_ptr(), fwd.grid, n, k, 7)
    assert f2[3] is None and f2[4] == f[4]
    assert f[6] == loss.data_ptr() and w_sum.data_ptr() == loss.data_ptr() + 4
    # backward: logits, target, weight, wsum, grad, dlogits, blocks, n, k, stream
    assert b[:4] == (logits.data_ptr(), tgt.data_ptr(), w.data_ptr(), w_sum.data_ptr())
    assert (b[5], b[6], b[7], b[8], b[9]) == (d.data_ptr(), back.grid, n, k, 7)
    assert d.shape == logits.shape and d.dtype == torch.float32


def test_scratch_grows_for_a_larger_grid(fake_card, monkeypatch):
    """A call whose grid needs more partials than the stream's scratch holds
    gets a new, larger, zeroed scratch; a smaller one reuses it."""
    args = (torch.zeros((4, 64, 64, 19)), torch.zeros((4, 64, 64), dtype=torch.int32),
            torch.ones(19))
    monkeypatch.setattr(wc, "_co_resident", lambda device, mode, k: 8)
    wc.weighted_ce(*args)
    small = wc._SCRATCH[(None, 7)]
    assert small.numel() == wc.COUNTER_WORDS + 2 * 8
    monkeypatch.setattr(wc, "_co_resident", lambda device, mode, k: 64)
    wc.weighted_ce(*args)
    big = wc._SCRATCH[(None, 7)]
    assert big.numel() == wc.COUNTER_WORDS + 2 * 64 and not big.any()
    monkeypatch.setattr(wc, "_co_resident", lambda device, mode, k: 8)
    wc.weighted_ce(*args)
    assert wc._SCRATCH[(None, 7)] is big
    assert [a[4] for _, a in fake_card] == [small.data_ptr(), big.data_ptr(), big.data_ptr()]


@pytest.mark.parametrize("name", [n for n, edits in weighted_ce_phases.VARIANTS.items()
                                  if edits])
def test_phases_variants_find_their_anchors(name):
    """Each source variant of ops/weighted_ce_phases.py edits text that the
    kernel source holds exactly once."""
    src = SOURCE.read_text()
    for old, _ in weighted_ce_phases.VARIANTS[name]:
        assert src.count(old) == 1, old


def block_case(k: int, seed: int):
    """(logits, targets, weights): float32 logits (2, 16, 24, k), targets
    constant over 8 x 8 blocks (as FLAIR's masks are over regions), a
    first-maximum tie at one pixel, two classes of weight 0."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((2, 16, 24, k)) * 3).astype(np.float32)
    logits[0, 0, 0, :2] = 20.0  # a tie: the first maximum wins
    logits[1, 5, 7, [3, k - 1]] = 20.0
    blocks = rng.integers(0, k, (2, 2, 3))
    tgt = np.kron(blocks, np.ones((8, 8), np.int64)).astype(np.int32)
    weights = np.array([0.0 if c in (k - 2, k // 2) else 1.0 for c in range(k)], np.float32)
    return logits, tgt, weights


@pytest.mark.parametrize("k", [13, 15, 19])
def test_plain_versions_match_flairtpu(k):
    """Loss (rtol 1e-6), weight sum (exact), gradient (1e-6 of the largest)
    and confusion matrix (exact) of the plain versions, and through the
    autograd Function, against flairtpu's _loss, its jax.grad and
    confusion_matrix."""
    logits, tgt, weights = block_case(k, seed=k)
    ns = SimpleNamespace(class_weights=jnp.asarray(weights))
    want = FlaxTrainer._loss(ns, jnp.asarray(logits), jnp.asarray(tgt))
    want_g = jax.grad(lambda lg: FlaxTrainer._loss(ns, lg, jnp.asarray(tgt)))(
        jnp.asarray(logits))
    want_cm = np.asarray(confusion_matrix(jnp.argmax(jnp.asarray(logits), axis=-1),
                                          jnp.asarray(tgt), k))
    assert want_cm[tgt[0, 0, 0], 0] >= 1  # the tie went to the first maximum

    lt, tt, wt = torch.from_numpy(logits), torch.from_numpy(tgt), torch.from_numpy(weights)
    cm = torch.zeros((k, k), dtype=torch.int32)
    loss, w_sum = wc.weighted_ce(lt, tt, wt, cm)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    assert w_sum.item() == float(weights[tgt].sum())
    np.testing.assert_array_equal(cm.numpy(), want_cm)
    g = wc.weighted_ce_grad(lt, tt, wt, w_sum, torch.tensor(1.0))
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want_g).max()))
    leaf = lt.clone().requires_grad_(True)
    fn_loss = wc.WeightedCE.apply(leaf, tt, wt, cm)
    fn_loss.backward()
    assert fn_loss.item() == loss.item() and torch.equal(leaf.grad, g)
    assert torch.equal(cm, 2 * torch.tensor(want_cm))
