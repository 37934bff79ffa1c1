"""augment_normalize's launch plan (``ops/augment.py:launch_plan``): its
constants against the kernel source, the tiled instance at a train batch
(16 x 512² x 5: bf16, float32, no mask) and the general instance at the edge
geometries chip_smoke checks on the card; what the wrapper tells the C entry
point; a transcription of the tiled kernel's per-tile affine source map,
against ``flairtpu``'s flips and ``_rot90`` at three sizes; a numpy
transcription of the tiled kernel's staged reads (pitch, chunk columns,
whole-word rows) against the plain version; and the phases tool's source
edits. Pure Python apart from a few small JAX calls: the kernel runs only on
a card, where ``chip_smoke.py`` holds both instances against the plain
version.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flairtpu.data.augment import _rot90
from flairtpu_torch.ops import augment as au
from flairtpu_torch.ops import augment_normalize_phases

SOURCE = Path(au.__file__).resolve().parent.parent / "csrc" / "augment_normalize.cu"
CHOICES = [(v, h, k) for v in (0, 1) for h in (0, 1) for k in range(4)]
SHARED_BYTES = 48 * 1024  # dynamic shared memory a block gets without opting in
BF16, F32 = torch.bfloat16, torch.float32
TRAIN = (16, 512, 512, 5)
# (batch, height, width, channels, has_mask, aligned) that take the general
# instance: a side not a multiple of the tile, channels over the tiled
# instance's, a pointer off 16-byte alignment, a non-square identity
GENERAL_EDGES = {
    "500² (16 choices)": (16, 500, 500, 5, True, True),
    "C = 1 at 100²": (2, 100, 100, 1, True, True),
    "C = 3 at 100²": (2, 100, 100, 3, True, True),
    "C = 8 at 100²": (2, 100, 100, 8, True, True),
    "C = 12 at 512²": (2, 512, 512, 12, True, True),
    "batch 1 at 500²": (1, 500, 500, 5, True, True),
    "one byte off alignment": (2, 512, 512, 5, True, False),
    "384 x 512 identity": (2, 384, 512, 5, True, True),
}
# shapes that take the tiled instance besides the train batch
TILED_EDGES = {"C = 1": (2, 512, 512, 1), "C = 3": (2, 512, 512, 3),
               "C = 8": (2, 512, 512, 8), "batch 1": (1, 512, 512, 5),
               "64²": (3, 64, 64, 5)}


def source_pixel(i: int, j: int, v: int, h: int, k: int, n: int) -> tuple[int, int]:
    """The source pixel (r, c) of output (i, j) of an n x n sample under
    (v, h, k): the kernel's ``source``."""
    p, q = ((i, j), (j, n - 1 - i), (n - 1 - i, n - 1 - j), (n - 1 - j, i))[k & 3]
    return (n - 1 - p if v else p), (n - 1 - q if h else q)


def tile_source_map(i0: int, j0: int, v: int, h: int, k: int, n: int,
                    tile: int = au.TILE) -> tuple[int, int, int, int, int, int, int, int]:
    """The tiled kernel's source map of the output tile at (i0, j0), as it
    works it out once a block: (r0, c0) the source tile's corner, (sr0,
    sc0) the staged position of output (i0, j0), and the steps (dri, dci) a
    tile row and (drj, dcj) a tile column; output (i0 + ii, j0 + jj) reads
    staged pixel (sr0 + ii * dri + jj * drj, sc0 + ii * dci + jj * dcj)."""
    ra, ca = source_pixel(i0, j0, v, h, k, n)
    rb, cb = source_pixel(i0 + 1, j0, v, h, k, n)
    rc, cc = source_pixel(i0, j0 + 1, v, h, k, n)
    dri, dci, drj, dcj = rb - ra, cb - ca, rc - ra, cc - ca
    r0 = ra + (tile - 1) * (min(dri, 0) + min(drj, 0))
    c0 = ca + (tile - 1) * (min(dci, 0) + min(dcj, 0))
    return r0, c0, ra - r0, ca - c0, dri, dci, drj, dcj


def const(src: str, name: str) -> int:
    return int(re.search(rf"\b{name} = (\d+)[;,]", src).group(1))


def test_plan_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    assert const(src, "kTile") == au.GENERAL_TILE
    assert const(src, "kThreads") == au.GENERAL_THREADS
    assert const(src, "kBigTile") == au.TILE
    assert const(src, "kBigThreads") == au.TILE_THREADS
    assert const(src, "kBigMaxChannels") == au.TILE_MAX_CHANNELS
    assert const(src, "kPadBytes") == au.PAD_BYTES
    assert const(src, "kAlign") == au.ALIGN
    assert const(src, "kMaxChannels") == au.MAX_CHANNELS
    assert {"general": const(src, "kGeneral"), "tiled": const(src, "kTiled")} == au.INSTANCES
    copy = const(src, "kCopyBytes")
    assert copy in (4, 8, 16) and au.PAD_BYTES % copy == 0
    for c in range(1, au.TILE_MAX_CHANNELS + 1):
        pitch = au.TILE * c + au.PAD_BYTES
        assert (au.TILE * c) % copy == 0 and (pitch // 4) % 2 == 1  # an odd number of words
        assert (au.TILE + au.PAD_BYTES) // 4 % 2 == 1  # the mask's rows too


@pytest.mark.parametrize("dtype,mask", [(BF16, True), (F32, True), (BF16, False)],
                         ids=["bf16", "f32", "no_mask"])
def test_train_batch_takes_the_tiled_instance(dtype, mask):
    """At 16 x 512² x 5: one block a 64 x 64 output tile, a whole number of
    a tile row's 16-byte chunks a block, the staged tiles within the shared
    memory a block gets without opting in."""
    B, H, W, C = TRAIN
    plan = au.launch_plan(B, H, W, C, dtype, mask, True)
    assert plan.instance == "tiled" and plan.grid == (W // au.TILE, H // au.TILE, B)
    chunks = au.TILE * C * dtype.itemsize // 16
    assert plan.threads % chunks == 0 and chunks <= plan.threads <= au.TILE_THREADS
    assert plan.threads == 240  # 6 rows of 40 bf16 chunks; 3 of 80 float32 chunks
    pitch = au.TILE * C + au.PAD_BYTES
    assert plan.smem_bytes == au.TILE * pitch + (au.TILE * (au.TILE + au.PAD_BYTES)
                                                 if mask else 0)
    assert plan.smem_bytes <= SHARED_BYTES


@pytest.mark.parametrize("name", TILED_EDGES)
def test_other_tiled_shapes(name):
    B, H, W, C = TILED_EDGES[name]
    for dtype in (BF16, F32):
        for mask in (True, False):
            plan = au.launch_plan(B, H, W, C, dtype, mask, True)
            assert plan.instance == "tiled" and plan.grid == (W // 64, H // 64, B)
            assert plan.threads % (64 * C * dtype.itemsize // 16) == 0
            assert plan.threads <= au.TILE_THREADS and plan.smem_bytes <= SHARED_BYTES


@pytest.mark.parametrize("name", GENERAL_EDGES)
def test_edge_geometries_take_the_general_instance(name):
    B, H, W, C, mask, aligned = GENERAL_EDGES[name]
    for dtype in (BF16, F32):
        plan = au.launch_plan(B, H, W, C, dtype, mask, aligned)
        assert plan.instance == "general"
        gx, gy, gz = plan.grid
        assert (gx - 1) * au.GENERAL_TILE < W <= gx * au.GENERAL_TILE
        assert (gy - 1) * au.GENERAL_TILE < H <= gy * au.GENERAL_TILE and gz == B
        assert plan.threads == au.GENERAL_THREADS
        assert plan.smem_bytes == au.GENERAL_TILE ** 2 * (C + 1) <= SHARED_BYTES


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's card path on CPU tensors, its C entry point recorded."""
    calls = []

    def entry(name, argtypes):
        assert name == "augment_normalize" and len(argtypes) == len(au.ARGTYPES)
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(au, "_on_card", lambda img: True)
    monkeypatch.setattr(au, "launches", 0)
    monkeypatch.setattr(au, "tiled_launches", 0)
    monkeypatch.setattr(au._build, "entry", entry)
    monkeypatch.setattr(au._build, "stream_handle", lambda t: 7)
    return calls


def test_wrapper_tells_the_entry_point_the_instance(fake_card):
    """The instance is the C entry point's last argument; a view one byte
    off alignment and a non-square identity take the general instance; the
    count goes up once a call, the tiled count once a tiled call."""
    mean, mul = torch.zeros(5), torch.ones(5)
    base = torch.zeros(2 * 64 * 64 * 5 + 1, dtype=torch.uint8)
    aligned = base[:-1].view(2, 64, 64, 5)
    off = base[1:].view(2, 64, 64, 5)
    mask = torch.ones((2, 64, 64), dtype=torch.uint8)
    ch = torch.zeros((2, 3), dtype=torch.int32)
    cases = [(aligned, mask, ch, BF16, "tiled"), (aligned, None, None, F32, "tiled"),
             (off, mask, ch, BF16, "general"),
             (torch.zeros((1, 64, 128, 5), dtype=torch.uint8), None, None, BF16, "general")]
    for img, msk, choices, dtype, want in cases:
        x, t = au.augment_normalize(img, msk, choices, mean, mul, 19, dtype)
        args = fake_card[-1]
        assert args[-1] == au.INSTANCES[want]
        assert args[0] == img.data_ptr() and args[5] == x.data_ptr()
        assert args[7:13] == (*img.shape, 19, int(dtype == F32)) and args[13] == 7
        assert x.dtype == dtype and (t is None) == (msk is None)
    assert au.launches == 4 and au.tiled_launches == 2
    if aligned.data_ptr() % au.ALIGN == 0:
        assert off.data_ptr() % au.ALIGN != 0


def tile_map(n: int, v: int, h: int, k: int) -> np.ndarray:
    """(n, n) flat source index r * n + c of each output pixel, through
    tile_source_map tile by tile; each staged position inside its tile."""
    out = np.full((n, n), -1, np.int64)
    ii, jj = np.meshgrid(np.arange(au.TILE), np.arange(au.TILE), indexing="ij")
    for i0 in range(0, n, au.TILE):
        for j0 in range(0, n, au.TILE):
            r0, c0, sr0, sc0, dri, dci, drj, dcj = tile_source_map(i0, j0, v, h, k, n)
            sr, sc = sr0 + ii * dri + jj * drj, sc0 + ii * dci + jj * dcj
            assert sr.min() == 0 and sr.max() == au.TILE - 1
            assert sc.min() == 0 and sc.max() == au.TILE - 1
            assert 0 <= r0 <= n - au.TILE and 0 <= c0 <= n - au.TILE
            assert r0 % au.TILE == 0 and c0 % au.TILE == 0  # whole 16-byte rows
            out[i0:i0 + au.TILE, j0:j0 + au.TILE] = (r0 + sr) * n + c0 + sc
    return out


@pytest.mark.parametrize("n", [64, 128, 256])
def test_tile_source_map_matches_flairtpu(n):
    """All 16 (v, h, k): the flips, then flairtpu/data/augment.py:_rot90,
    through jnp on an image of source indices."""
    index = jnp.arange(n * n, dtype=jnp.int32).reshape(n, n)
    for v, h, k in CHOICES:
        a = index
        if v:
            a = jnp.flip(a, axis=0)
        if h:
            a = jnp.flip(a, axis=1)
        want = np.asarray(_rot90(a, jnp.int32(k)))
        np.testing.assert_array_equal(tile_map(n, v, h, k), want, err_msg=str((v, h, k)))
        i, j = 5, n - 3
        assert source_pixel(i, j, v, h, k, n) == divmod(int(want[i, j]), n)


def emulate_tiled(img, mask, choices, mean, mul, n_classes, dtype):
    """The tiled kernel's reads in numpy: each block stages its source and
    mask tiles at the padded pitches; a thread's chunk column q reads its
    values at base + ii * si + its relative offsets (whole words where the
    row runs forward, which must then be 4-byte aligned); each byte as
    float32 (x - mean) * mul, rounded once."""
    B, n, _, C = img.shape
    T, pad = au.TILE, au.PAD_BYTES
    vals = 16 // dtype.itemsize
    pitch, mpitch = T * C + pad, T + pad
    x = np.zeros((B, n, n, C), np.float32)
    tgt = np.zeros((B, n, n), np.int32)
    q = np.arange(T * C // vals)
    u = vals * q[:, None] + np.arange(vals)
    jj, ch = u // C, u % C
    rows = np.arange(T)[:, None, None]
    for b in range(B):
        v, h, k = choices[b] if choices is not None else (0, 0, 0)
        for i0 in range(0, n, T):
            for j0 in range(0, n, T):
                r0, c0, sr0, sc0, dri, dci, drj, dcj = tile_source_map(i0, j0, v, h, k, n)
                staged = np.zeros(T * pitch, np.uint8)
                for r in range(T):
                    staged[r * pitch:r * pitch + T * C] = img[b, r0 + r, c0:c0 + T].ravel()
                si, sj = dri * pitch + dci * C, drj * pitch + dcj * C
                offs = sr0 * pitch + sc0 * C + rows * si + (jj * sj + ch)[None]
                if sj == C:  # the forward rows: whole words from a word boundary
                    assert ((sr0 * pitch + sc0 * C + rows * si + vals * q[None, :, None])
                            % 4 == 0).all()
                assert ((offs % pitch) < T * C).all()  # never the pad
                got = (staged[offs].astype(np.float32) - mean[ch]) * mul[ch]
                x[b, i0:i0 + T, j0:j0 + T] = got.reshape(T, T, C)
                if mask is not None:
                    sm = np.zeros(T * mpitch, np.uint8)
                    for r in range(T):
                        sm[r * mpitch:r * mpitch + T] = mask[b, r0 + r, c0:c0 + T]
                    mi, mj = dri * mpitch + dci, drj * mpitch + dcj
                    t = sm[sr0 * mpitch + sc0 + rows[..., 0] * mi
                           + np.arange(T)[None] * mj].astype(np.int32) - 1
                    tgt[b, i0:i0 + T, j0:j0 + T] = np.where((t >= 0) & (t < n_classes), t, 0)
    out = torch.from_numpy(x).to(dtype)
    return out, (torch.from_numpy(tgt) if mask is not None else None)


@pytest.mark.parametrize("c,dtype", [(5, BF16), (5, F32), (3, BF16), (1, F32), (8, BF16)],
                         ids=str)
def test_tiled_reads_match_the_plain_version(c, dtype):
    """The 16 choices at 128² (4 tiles a sample), labels 0 and > K on disk:
    bit for bit."""
    rng = np.random.default_rng(c)
    n, K = 128, 19
    img = rng.integers(0, 256, (16, n, n, c), dtype=np.uint8)
    msk = rng.integers(0, K + 7, (16, n, n), dtype=np.uint8)
    mean = rng.uniform(0, 120, c).astype(np.float32)
    mul = (1 / rng.uniform(30, 80, c)).astype(np.float32)
    x, t = emulate_tiled(img, msk, CHOICES, mean, mul, K, dtype)
    xp, tp = au.augment_normalize_plain(
        torch.from_numpy(img), torch.from_numpy(msk), torch.tensor(CHOICES, dtype=torch.int32),
        torch.from_numpy(mean), torch.from_numpy(mul), K, dtype)
    assert torch.equal(x, xp) and torch.equal(t, tp)
    x, t = emulate_tiled(img[:2], None, None, mean, mul, K, dtype)
    xp, _ = au.augment_normalize_plain(torch.from_numpy(img[:2]), None, None,
                                       torch.from_numpy(mean), torch.from_numpy(mul), K, dtype)
    assert torch.equal(x, xp) and t is None


def column_walk_wavefronts(c: int, dtype: torch.dtype, pitch: int, k: int) -> float:
    """The mean shared-memory wavefronts of the tiled kernel's byte reads
    at rotation k (the 4 flips), one warp instruction at a time: each of a
    warp's 32 lanes reads one value of its chunk, and a bank serves one
    4-byte word a wavefront."""
    vals = 16 // dtype.itemsize
    cpr = au.TILE * c // vals
    threads = au.launch_plan(1, au.TILE, au.TILE, c, dtype, False, True).threads
    counts = []
    for v, h in ((0, 0), (0, 1), (1, 0), (1, 1)):
        _, _, sr0, sc0, dri, dci, drj, dcj = tile_source_map(0, 0, v, h, k, au.TILE)
        for ii0 in range(0, au.TILE, threads // cpr):
            for w in range(0, threads, 32):
                t = np.arange(w, min(w + 32, threads))
                ii, q = ii0 + t // cpr, t % cpr
                q, ii = q[ii < au.TILE], ii[ii < au.TILE]
                for e in range(vals if len(q) else 0):
                    jj, ch = divmod(vals * q + e, c)
                    r, col = sr0 + ii * dri + jj * drj, sc0 + ii * dci + jj * dcj
                    words = np.unique((r * pitch + col * c + ch) // 4)
                    counts.append(np.bincount(words % 32).max())
    return float(np.mean(counts))


def test_padded_pitch_spreads_the_column_walk():
    """At C = 5 in bf16, the rotated read (k = 1, 3) takes about 2.6
    wavefronts a byte read at the kernel's pitch (an odd number of words),
    as many as the straight read (k = 0, 2) to within one; a pitch of whole
    16-byte chunks (what 16-byte copies need) about 5.5, the unpadded one
    about 10.6."""
    row = au.TILE * 5
    got = {pad: [column_walk_wavefronts(5, BF16, row + pad, k) for k in range(4)]
           for pad in (au.PAD_BYTES, 16, 0)}
    padded, chunked, unpadded = got[au.PAD_BYTES], got[16], got[0]
    assert max(padded[1], padded[3]) < 3 and abs(padded[1] - padded[0]) < 1
    assert 5 < min(chunked[1], chunked[3]) and max(chunked[1], chunked[3]) < 6
    assert min(unpadded[1], unpadded[3]) > 10


@pytest.mark.parametrize("name", [n for n, edits in augment_normalize_phases.SOURCES.items()
                                  if edits])
def test_phases_sources_find_their_anchors(name):
    """Each source variant of ops/augment_normalize_phases.py edits text
    that the kernel source holds exactly once."""
    src = SOURCE.read_text()
    for old, _ in augment_normalize_phases.SOURCES[name]:
        assert src.count(old) == 1, old


def test_phases_variants_name_their_sources_and_calls():
    calls = {"train", "identity", "no_mask", "f32", "k0", "k1", "k2", "k3"}
    for name, (src, call, instance) in augment_normalize_phases.VARIANTS.items():
        assert src in augment_normalize_phases.SOURCES and call in calls
        assert instance in au.INSTANCES
    assert set(augment_normalize_phases.BASELINE_CALLS) <= calls
