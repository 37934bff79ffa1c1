"""strided_tail's launch plan and arithmetic (``ops/strided_tail.py:
launch_plan``, ``csrc/strided_tail.cu``), pure numpy and torch on the CPU:

- every tap with a weight of every owned row and column lies in the source
  run its block stages, at the geometries chip_smoke holds the kernel at
  (STRIDED_CASES, STRIDED_EDGES, the 1000 x 1100 zone's partial windows),
  and each plan fits the shared memory a block may opt into;
- the plan's constants and layout match the kernel source;
- a float32 transcription of the kernel's banded two passes (staged H pass,
  then W pass, each product and sum rounded on its own) equals a
  transcription of the per-pixel formula it replaced bit for bit, and the plain
  version within STRIDED_TOL of the largest |logit|;
- the epilogue's first maximum and its division from one reciprocal
  (Markstein's correction) against the plain definitions;
- what the wrapper tells the C entry point, and the phases tool's source
  edits.

The kernel itself runs only on a card (``chip_smoke.py`` phase 2 and
``ops/strided_tail_phases.py`` hold it to the plain version and to the
per-pixel kernel of fe34f71 there).
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from flairtpu_torch.ops import strided_tail as sp
from flairtpu_torch.ops import strided_tail_phases
from flairtpu_torch.zone.device_engine import exact_windows
from flairtpu_torch.zone.grid import slice_grid

SOURCE = Path(sp.__file__).resolve().parent.parent / "csrc" / "strided_tail.cu"
MODES = (sp.ARGMAX, sp.PROBS, sp.LOGITS)
# (tile, margin, upsample, classes, batch): chip_smoke's main-path cases
# (argmax and probs at its margin, logits at margin 0) and its edges
GEOMETRIES = ([(cs.S, cs.M, up, cs.K, cs.BATCH) for _, up in cs.STRIDED_CASES]
              + [(cs.S, 0, up, cs.K, cs.BATCH) for _, up in cs.STRIDED_CASES]
              + list(cs.STRIDED_EDGES)
              + [(size, 0, up, k, b) for size, _, up, k, b in cs.STRIDED_EDGES])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def staged(idx: np.ndarray, first: int, last: int) -> tuple[int, int]:
    """The source indices [lo[first], hi[last]] a block of window indices
    [first, last] stages, from the kernel's taps."""
    return int(idx[0][first]), int(idx[1][last])


def assert_covered(g, idx, wts, plan, lo: int, hi: int, step: int, extent: int):
    """Every tap with a weight of window indices [lo, hi), cut into blocks
    of ``step`` from 0 as the grid cuts them, lies in its block's staged
    run, which spans at most ``extent`` indices."""
    for b0 in range(0, g.out_extent, step):
        first, last = max(lo, b0), min(hi, b0 + step) - 1
        if first > last:
            continue
        s0, s1 = staged(idx, first, last)
        assert s1 - s0 + 1 <= extent
        for i in range(first, last + 1):
            assert s0 <= idx[0][i] <= s1
            assert wts[1][i] == 0 or s0 <= idx[1][i] <= s1


@pytest.mark.parametrize("size,margin,up,k,batch", GEOMETRIES)
def test_plan_covers_every_tap(size, margin, up, k, batch):
    g = sp.strided_geometry(size, margin, up)
    idx, wts = sp.kernel_taps(g)
    orig, _ = sp.taps(g)
    assert (np.diff(idx, axis=1) >= 0).all()  # nondecreasing, as the kernel takes them
    assert (idx[1] == np.where(wts[1] > 0, orig[1], orig[0])).all()
    for mode in MODES:
        plan = sp.launch_plan(g, k, mode, batch)
        s = g.out_extent
        assert plan.cols <= sp.THREADS and plan.smem_bytes <= sp.MAX_SMEM_BYTES
        assert plan.grid == (-(-s // plan.cols), -(-s // plan.rows), batch)
        assert plan.src_rows <= g.n_in and plan.src_cols <= g.n_in
        assert_covered(g, idx, wts, plan, 0, s, plan.rows, plan.src_rows)
        assert_covered(g, idx, wts, plan, 0, s, plan.cols, plan.src_cols)
        # owned windows cut out of the whole window stage less
        for lo, hi in ((1, s - 2), (s // 3, s // 3 + 5), (s - 1, s)):
            if lo < hi:
                assert_covered(g, idx, wts, plan, lo, hi, plan.rows, plan.src_rows)
                assert_covered(g, idx, wts, plan, lo, hi, plan.cols, plan.src_cols)


@pytest.mark.parametrize("up", [4, 8, 1])
def test_plan_covers_the_zone_windows(up):
    """The 1000 x 1100 zone chip_smoke writes through: each tile's owned
    window (the realigned last row and column own thin strips)."""
    g = sp.strided_geometry(cs.S, cs.M, up)
    idx, wts = sp.kernel_taps(g)
    tiles = slice_grid(1100, 1000, cs.S, cs.M).tiles
    wins = exact_windows(tiles, 1000, 1100, g.out_extent, len(tiles))
    for mode in (sp.ARGMAX, sp.PROBS):
        plan = sp.launch_plan(g, cs.K, mode, 8)
        for _, _, rlo, rhi, clo, chi in wins.tolist():
            if rlo < rhi and clo < chi:
                assert_covered(g, idx, wts, plan, rlo, rhi, plan.rows, plan.src_rows)
                assert_covered(g, idx, wts, plan, clo, chi, plan.cols, plan.src_cols)


def const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+);", src).group(1))


def test_plan_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    assert const(src, "kThreads") == sp.THREADS
    assert const(src, "kRunPad") == sp.RUN_PAD
    assert const(src, "kOutPadBytes") == sp.OUT_PAD_BYTES
    assert {"kArgmax": sp.ARGMAX, "kProbs": sp.PROBS, "kLogits": sp.LOGITS} == {
        m: int(v) for m, v in re.findall(r"(k\w+) = (\d)", src.split("enum Mode")[1][:80])}
    # the layout's terms, as smem_bytes mirrors them
    assert "return round4(src_cols * k + kRunPad);" in src
    assert "return 4 * (((k + 3) / 4) | 1);" in src
    assert "if (mode == kProbs) return (cols * k + kOutPadBytes + 15) & ~15;" in src
    assert "return mode == kLogits ? 4 * round4(cols * k + kOutPadBytes / 4) : 0;" in src
    assert "2LL * out_row_bytes(a.cols, a.k, mode);" in src
    assert "cols > kThreads" in src  # the entry point refuses a chunk wider than a block
    assert sp.CHUNK_COLS <= sp.THREADS


def test_smem_bytes_counts_each_buffer():
    """At U = 4 with 19 classes: 4 staged rows of 66 columns, 8 H-pass rows
    of 66 columns of 5 float4s, two output rows of 256 pixels."""
    stage = 4 * 4 * 1260  # 66 * 19 + 6 floats a row, whole float4s
    hbuf = 4 * 8 * 66 * 20
    assert sp.smem_bytes(8, 256, 4, 66, 19, sp.ARGMAX, False) == stage + hbuf
    assert sp.smem_bytes(8, 256, 4, 66, 19, sp.PROBS, False) == stage + hbuf + 2 * 4880
    assert sp.smem_bytes(8, 256, 4, 66, 19, sp.LOGITS, False) == stage + hbuf + 2 * 4 * 4868
    assert sp.smem_bytes(8, 256, 4, 66, 19, sp.ARGMAX, True) == stage


def f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def per_pixel_window(x: np.ndarray, g) -> np.ndarray:
    """fe34f71's kernel, a pixel at a time: four taps, the H pass at both
    columns, then the W pass; a pixel whose row and column have one tap
    each: wl_c (wl_r x)."""
    idx, wts = sp.taps(g)
    lr, hr, wlr, whr = idx[0][:, None], idx[1][:, None], wts[0][:, None], wts[1][:, None]
    lc, hc, wlc, whc = idx[0][None], idx[1][None], wts[0][None], wts[1][None]
    xs = [x[:, a, c] for a, c in ((lr, lc), (hr, lc), (lr, hc), (hr, hc))]
    w = [w[..., None] for w in (wlr, whr, wlc, whc)]
    t0 = f32(f32(w[0] * xs[0]) + f32(w[1] * xs[1]))
    t1 = f32(f32(w[0] * xs[2]) + f32(w[1] * xs[3]))
    v = f32(f32(w[2] * t0) + f32(w[3] * t1))
    one = ((whr == 0) & (whc == 0))[..., None]
    return np.where(one, f32(w[2] * f32(w[0] * xs[0])), v)


def banded_window(x: np.ndarray, g, k: int, mode: int) -> np.ndarray:
    """The kernel's arithmetic, block by block of launch_plan's grid: the
    staged source run, the H pass of each (window row, staged column), the
    W pass of each pixel from the H-pass buffer (U = 1: the staged value)."""
    idx, wts = sp.kernel_taps(g)
    plan = sp.launch_plan(g, k, mode, x.shape[0])
    s = g.out_extent
    out = np.full((x.shape[0], s, s, k), np.nan, np.float32)
    for b in range(x.shape[0]):
        for r0 in range(0, s, plan.rows):
            rows = np.arange(r0, min(r0 + plan.rows, s))
            sr0, sr1 = staged(idx, rows[0], rows[-1])
            for c0 in range(0, s, plan.cols):
                cols = np.arange(c0, min(c0 + plan.cols, s))
                sc0, sc1 = staged(idx, cols[0], cols[-1])
                assert sr1 - sr0 < plan.src_rows + 1 and sc1 - sc0 < plan.src_cols + 1
                run = x[b, sr0:sr1 + 1, sc0:sc1 + 1]  # (rows, columns, k)
                lc, hc = idx[0][cols] - sc0, idx[1][cols] - sc0
                if g.up == 1:
                    out[b, rows[:, None], cols] = run[idx[0][rows][:, None] - sr0, lc]
                    continue
                t = f32(f32(wts[0][rows][:, None, None] * run[idx[0][rows] - sr0])
                        + f32(wts[1][rows][:, None, None] * run[idx[1][rows] - sr0]))
                out[b, rows[:, None], cols] = f32(
                    f32(wts[0][cols][None, :, None] * t[:, lc])
                    + f32(wts[1][cols][None, :, None] * t[:, hc]))
    return out


@pytest.mark.parametrize("size,margin,up,k", [
    (64, 16, 4, 19), (64, 13, 4, 7), (48, 0, 4, 1), (72, 9, 8, 19), (64, 8, 8, 7),
    (40, 0, 8, 1), (36, 7, 1, 19), (32, 0, 1, 7), (200, 30, 4, 13)])
def test_banded_two_pass_matches_per_pixel_and_plain(size, margin, up, k):
    x = np.random.default_rng(size + k).normal(0, 2, (2, size // up, size // up, k))
    x = x.astype(np.float32)
    g = sp.strided_geometry(size, margin, up)
    want = per_pixel_window(x, g)
    for mode in MODES:
        got = banded_window(x, g, k, mode)
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(got == want, True)  # == : -0.0 equals 0.0
    plain = sp.upsample_window(torch.from_numpy(x), g).numpy()
    np.testing.assert_allclose(want, plain, rtol=0, atol=cs.STRIDED_TOL * np.abs(x).max())


def first_max_running(v: np.ndarray) -> int:
    mx, am = -np.inf, 0
    for j, x in enumerate(v):
        if x > mx:
            mx, am = x, j
    return am


def test_first_maximum_by_hits():
    """The kernel's class: the largest value, then the lowest class that
    holds it; fe34f71's running strict comparison on ties and signed zeros."""
    rng = np.random.default_rng(0)
    cases = [rng.normal(0, 2, 19).astype(np.float32) for _ in range(200)]
    cases += [np.float32([0.5, 2, 2, 1]), np.float32([2, 2, 2]), np.float32([-0.0, 0.0, -1]),
              np.float32([0.0, -0.0]), np.float32([-3.0]), np.float32([1, 3, 0, 3])]
    tie = rng.normal(0, 1, 19).astype(np.float32)
    tie[[0, 7]] = tie.max() + 1
    cases.append(tie)
    for v in cases:
        mx = np.float32(v[0])
        for x in v[1:]:
            mx = np.fmax(mx, x)
        hits = sum(1 << j for j, x in enumerate(v) if x == mx)
        assert (hits & -hits).bit_length() - 1 == first_max_running(v)


def rn32(x: Fraction) -> np.float32:
    """The exact value x rounded to the nearest float32, ties to even (the
    normal range)."""
    if x == 0:
        return np.float32(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += 1 if Fraction(2) ** e <= x else 0  # 2^(e-1) <= x < 2^e
    scaled = x * Fraction(2) ** (24 - e)  # in [2^23, 2^24)
    n, rem = divmod(scaled.numerator, scaled.denominator)
    if 2 * rem > scaled.denominator or (2 * rem == scaled.denominator and n % 2):
        n += 1
    return np.float32(sign * float(Fraction(n) * Fraction(2) ** (e - 24)))


def quotient(a: np.float32, b: np.float32, r: np.float32) -> np.float32:
    """The kernel's quotient: q = RN(a r), q + r (a - b q) with each FMA
    rounded once."""
    q = np.float32(a * r)
    rem = rn32(Fraction(float(a)) - Fraction(float(b)) * Fraction(float(q)))
    return rn32(Fraction(float(rem)) * Fraction(float(r)) + Fraction(float(q)))


def test_quotient_from_one_reciprocal_is_the_ieee_quotient():
    """a in [2^-90, 1] (a softmax term), b in [1, 32] (their sum): the
    quotient equals a / b rounded once (numpy's float32 division), and 255
    times it rounds to the same byte; below 2^-100 both bytes are 0."""
    rng = np.random.default_rng(5)
    a = np.exp(rng.uniform(-62, 0, 1500)).astype(np.float32)
    b = rng.uniform(1, 32, 1500).astype(np.float32)
    # the hard divisors: all-ones significands, powers of two, their neighbours
    hard = np.float32([1, 2, 3, 31, 19, np.nextafter(np.float32(2), 0), 1.9999999, 1.5])
    a = np.concatenate([a, np.float32([1, 2 ** -90, 0.5, 0.999999940])[:, None].repeat(8, 1)
                        .ravel(), rng.uniform(0, 1, 64).astype(np.float32)])
    b = np.concatenate([b, np.tile(hard, 4), np.resize(hard, 64)])
    for x, y in zip(a, b):
        r = np.float32(np.float32(1) / y)
        q = quotient(x, y, r)
        want = np.float32(x / y)
        assert q == want, (x, y)
        assert np.rint(np.float32(q * np.float32(255))) == np.rint(want * np.float32(255))
    tiny = np.float32(2 ** -101)
    r = np.float32(np.float32(1) / np.float32(19))
    assert np.rint(np.float32(quotient(tiny, np.float32(19), r) * np.float32(255))) == 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's card path on CPU tensors, its C entry point recorded."""
    calls = []

    def entry(name, argtypes):
        assert name == "strided_tail" and argtypes == sp.ARGTYPES
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(sp, "_on_card", lambda name, x: True)
    for count in ("launches", "probs_launches", "logits_launches"):
        monkeypatch.setattr(sp, count, 0)
    monkeypatch.setattr(sp._build, "entry", entry)
    monkeypatch.setattr(sp._build, "stream_handle", lambda t: 7)
    return calls


@pytest.mark.parametrize("up", [4, 1])
def test_wrappers_pass_the_plan(fake_card, up):
    """Each mode passes its plan after the mode: rows, cols, src_rows,
    src_cols, the identity flag, the shared bytes; then the stream. Each
    wrapper counts its launch."""
    size, margin, k, batch = 64, 16, 5, 2
    g, g0 = sp.strided_geometry(size, margin, up), sp.strided_geometry(size, 0, up)
    p = sp.StridedTail(up, k, torch.device("cpu"))
    x = torch.zeros((batch, size // up, size // up, k))
    s = g.out_extent
    sp.strided_tail(x, p, g)
    sp.strided_tail_probs(x, p, g, torch.zeros((batch * s, s, k), dtype=torch.uint8),
                          sp.full_windows(batch, s, x.device))
    sp.strided_tail_logits(x, p, g0)
    assert (sp.launches, sp.probs_launches, sp.logits_launches) == (1, 1, 1)
    for args, mode, geo in zip(fake_card, MODES, (g, g, g0)):
        plan = sp.launch_plan(geo, k, mode, batch)
        assert args[0] == x.data_ptr() and args[7:12] == (batch, geo.n_in, geo.out_extent,
                                                          k, mode)
        assert args[12:18] == (plan.rows, plan.cols, plan.src_rows, plan.src_cols,
                               int(up == 1), plan.smem_bytes)
        assert args[18] == 7 and len(args) == len(sp.ARGTYPES)


@pytest.mark.parametrize("name", [n for n, edits in strided_tail_phases.SOURCES.items() if edits])
def test_phases_sources_find_their_anchors(name):
    """Each source variant of ops/strided_tail_phases.py edits text that
    the kernel source holds exactly once."""
    src = SOURCE.read_text()
    for old, _ in strided_tail_phases.SOURCES[name]:
        assert src.count(old) == 1, old


def test_phases_variants_name_their_sources():
    ph = strided_tail_phases
    for src, over in ph.VARIANTS.values():
        assert src in ph.SOURCES and set(over) <= {"rows", "cols"}
    assert set(ph.SAME_BITS) <= set(ph.VARIANTS)
    assert ph.OLD_ARGTYPES == sp.ARGTYPES[:12] + sp.ARGTYPES[-1:]
