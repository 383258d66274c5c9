"""The port's host (C++) kernels, ``utils/native.py`` over its own copies of
``csrc/dls_native.cc`` and ``csrc/dls_jpeg.cc``, against the JAX package's
library and against their numpy plain versions, on the CPU.

- The baseline JPEG decode is bitwise the JAX package's, on the committed
  fixtures (``tests/fixtures/jpeg``, whose stored reference decodes the card's
  machine checks without PIL) and on JPEGs this test encodes with PIL
  (4:4:4, 4:2:2, 4:2:0, grayscale, odd sizes); non-baseline streams are
  refused as the reference refuses them.
- The float kernels match the reference's at its own tests' tolerances:
  1e-6 for crop/flip/normalize and normalize, 1e-5 for the resize and the
  fused random-resized-crop (the numpy chain rounds its intermediate frame
  differently); the port's and the reference's libraries agree bitwise.
- The build: a failed ``g++`` raises with the compiler's output (no quiet
  numpy); ``DLS_DISABLE_NATIVE`` is the only way to the plain versions; two
  libraries with the same ``dls_*`` symbols live in one process."""

import io
from pathlib import Path

import numpy as np
import pytest

from distributeddeeplearningspark_tpu.utils import native as jnative
from distributeddeeplearningspark_tpu_torch.data import vision as tvision
from distributeddeeplearningspark_tpu_torch.utils import native as tnative
from test_torch_deadline import per_test

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(autouse=True)
def _deadline():
    """Each test under a deadline of its own (``test_torch_deadline``)."""
    yield from per_test()


def _jpeg(arr: np.ndarray, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _smooth(rng, h, w, c=3):
    y, x = np.mgrid[0:h, 0:w]
    img = (y[..., None] * rng.uniform(0.2, 1.0, c) + x[..., None] * rng.uniform(0.2, 1.0, c)
           + rng.normal(0, 6, (h, w, c)))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_the_library_builds_and_loads():
    assert tnative.available() and tnative.num_threads() >= 1
    path = tnative.library_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("name", sorted(p.stem for p in FIXTURES.glob("*.jpg")))
def test_fixture_decodes_bitwise_as_the_reference(name):
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    got = tnative.jpeg_decode(data)
    np.testing.assert_array_equal(got, jnative.jpeg_decode(data))
    np.testing.assert_array_equal(got, np.load(FIXTURES / "decoded.npz")[name])


def test_fixtures_cover_classes_sizes_and_sampling():
    names = sorted(p.stem for p in FIXTURES.glob("*.jpg"))
    assert len({n.split("_")[0] for n in names}) == 4 and len(names) == 8
    shapes = [tnative.jpeg_decode((FIXTURES / f"{n}.jpg").read_bytes()).shape
              for n in names]
    assert min(s[1] for s in shapes) == 180 and max(s[1] for s in shapes) == 500
    assert {s[2] for s in shapes} == {1, 3}
    assert sum(p.stat().st_size for p in FIXTURES.glob("*.jpg")) < 300_000


@pytest.mark.parametrize("shape,kw", [
    ((64, 48, 3), dict(quality=95, subsampling=0)),
    ((61, 83, 3), dict(quality=90, subsampling=1)),
    ((97, 130, 3), dict(quality=75, subsampling=2)),
    ((33, 17, 3), dict(quality=90)),
    ((50, 70, 1), dict(quality=85)),
])
def test_decode_is_the_references_bitwise(shape, kw):
    rng = np.random.default_rng(sum(shape))
    arr = _smooth(rng, *shape)
    data = _jpeg(arr[..., 0] if shape[2] == 1 else arr, **kw)
    got = tnative.jpeg_decode(data)
    assert got.shape == shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jnative.jpeg_decode(data))
    # a 4:4:4 high-quality stream is within a few LSBs of PIL's decode
    if kw.get("subsampling") == 0:
        from PIL import Image

        pil = np.asarray(Image.open(io.BytesIO(data)))
        assert np.abs(pil.astype(int) - got.astype(int)).max() <= 8


def test_batch_decode_equals_single_decodes():
    rng = np.random.default_rng(4)
    datas = [_jpeg(_smooth(rng, 40 + 7 * i, 60 - 3 * i)) for i in range(6)]
    got = tnative.jpeg_decode_batch(datas)
    for g, d in zip(got, datas):
        np.testing.assert_array_equal(g, tnative.jpeg_decode(d))
    assert tnative.jpeg_decode_batch([]) == []


def test_non_baseline_and_malformed_streams():
    rng = np.random.default_rng(5)
    arr = _smooth(rng, 40, 56)
    progressive = _jpeg(arr, quality=90, progressive=True)
    with pytest.raises(tnative.JpegUnsupported):
        tnative.jpeg_decode(progressive)
    with pytest.raises(jnative.JpegUnsupported):
        jnative.jpeg_decode(progressive)
    # decode_jpeg hands it to PIL, as the reference does
    np.testing.assert_array_equal(tvision.decode_jpeg(progressive),
                                  jnative_vision_decode(progressive))
    with pytest.raises(ValueError, match="malformed"):
        tnative.jpeg_decode(b"\xff\xd8\xff\xe0 not a jpeg")
    with pytest.raises(ValueError):
        tnative.jpeg_decode_batch([_jpeg(arr), b"\x00\x01"])


def jnative_vision_decode(data: bytes) -> np.ndarray:
    from distributeddeeplearningspark_tpu.data import vision as jvision

    return jvision.decode_jpeg(data)


def test_decode_jpeg_reads_paths_and_bytes_as_the_reference(tmp_path):
    rng = np.random.default_rng(6)
    data = _jpeg(_smooth(rng, 45, 38))
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    want = jnative_vision_decode(data)
    np.testing.assert_array_equal(tvision.decode_jpeg(str(path)), want)
    np.testing.assert_array_equal(tvision.decode_jpeg(bytearray(data)), want)


def _plain(monkeypatch, fn, *args, **kw):
    """``fn`` on its numpy plain version (``DLS_DISABLE_NATIVE``)."""
    with monkeypatch.context() as m:
        m.setenv(tnative.DISABLE_ENV, "1")
        assert not tnative.available()
        return fn(*args, **kw)


def test_crop_flip_normalize_and_normalize(monkeypatch):
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (5, 40, 36, 3), dtype=np.uint8)
    ys = rng.integers(0, 40 - 24 + 1, 5).astype(np.int32)
    xs = rng.integers(0, 36 - 20 + 1, 5).astype(np.int32)
    flips = np.array([0, 1, 1, 0, 1], np.uint8)
    args = (imgs, ys, xs, flips, (24, 20), MEAN, STD)
    got = tnative.crop_flip_normalize_batch(*args)
    assert got.shape == (5, 24, 20, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.crop_flip_normalize_batch(*args))
    np.testing.assert_allclose(
        got, _plain(monkeypatch, tnative.crop_flip_normalize_batch, *args),
        rtol=1e-6, atol=1e-6)
    got = tnative.normalize_u8_batch(imgs, MEAN, STD)
    np.testing.assert_array_equal(got, jnative.normalize_u8_batch(imgs, MEAN, STD))
    np.testing.assert_allclose(
        got, _plain(monkeypatch, tnative.normalize_u8_batch, imgs, MEAN, STD),
        rtol=1e-6, atol=1e-6)


def test_resize_bilinear(monkeypatch):
    rng = np.random.default_rng(8)
    for shape, size in [((37, 53, 3), (20, 31)), ((16, 16, 3), (40, 25)),
                        ((29, 31), (11, 47))]:
        img = rng.uniform(0, 255, shape).astype(np.float32)
        got = tnative.resize_bilinear(img, size)
        assert got.shape == size + shape[2:]
        np.testing.assert_array_equal(got, jnative.resize_bilinear(img, size))
        if img.ndim == 3:  # the numpy resize takes HWC only
            np.testing.assert_allclose(got, tvision.resize_bilinear(img, size),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got, _plain(monkeypatch, tnative.resize_bilinear, img, size),
            rtol=1e-5, atol=1e-5)


def _rrc_chain(img, region, flip, size):
    """The numpy chain the fused kernel replaces: crop, resize, flip, normalize."""
    y, x, ch, cw = region
    out = tvision.resize_bilinear(img[y:y + ch, x:x + cw].astype(np.float32) / 255.0,
                                  (size, size))
    return tvision.normalize(out[:, ::-1] if flip else out)


def test_rrc_flip_normalize_and_its_batch_form():
    rng = np.random.default_rng(9)
    imgs, regions, flips = [], [], []
    for i in range(6):
        h, w = 30 + 9 * i, 50 - 4 * i
        imgs.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        ch, cw = int(rng.integers(8, h + 1)), int(rng.integers(8, w + 1))
        regions.append((int(rng.integers(0, h - ch + 1)),
                        int(rng.integers(0, w - cw + 1)), ch, cw))
        flips.append(i % 2)
    singles = []
    for img, region, flip in zip(imgs, regions, flips):
        got = tnative.rrc_flip_normalize(img, region, bool(flip), (24, 24), MEAN, STD)
        np.testing.assert_array_equal(got, jnative.rrc_flip_normalize(
            img, region, bool(flip), (24, 24), MEAN, STD))
        np.testing.assert_allclose(got, _rrc_chain(img, region, flip, 24),
                                   rtol=1e-5, atol=1e-5)
        singles.append(got)
    batch = tnative.rrc_flip_normalize_varbatch(
        imgs, np.asarray(regions, np.int32), np.asarray(flips, np.uint8), (24, 24),
        MEAN, STD)
    np.testing.assert_array_equal(batch, np.stack(singles))
    out = np.zeros_like(batch)
    assert tnative.rrc_flip_normalize_varbatch(
        imgs, np.asarray(regions, np.int32), np.asarray(flips, np.uint8), (24, 24),
        MEAN, STD, out=out) is out
    np.testing.assert_array_equal(out, batch)


def test_kernels_refuse_what_would_read_out_of_bounds():
    img = np.zeros((2, 10, 10, 3), np.uint8)
    with pytest.raises(ValueError, match="out of bounds"):
        tnative.crop_flip_normalize_batch(img, np.array([0, 5], np.int32),
                                          np.zeros(2, np.int32), np.zeros(2),
                                          (8, 8), MEAN, STD)
    with pytest.raises(ValueError, match="exceeds"):
        tnative.crop_flip_normalize_batch(img, np.zeros(2, np.int32),
                                          np.zeros(2, np.int32), np.zeros(2),
                                          (12, 8), MEAN, STD)
    with pytest.raises(ValueError, match="out of bounds"):
        tnative.rrc_flip_normalize(img[0], (4, 0, 8, 8), False, (4, 4), MEAN, STD)
    with pytest.raises(ValueError, match="flips"):
        tnative.rrc_flip_normalize_varbatch([img[0]], np.array([[0, 0, 4, 4]]),
                                            np.zeros(2), (4, 4), MEAN, STD)
    with pytest.raises(ValueError, match="size mismatch"):
        tnative.sum_into(np.zeros(4, np.float32), np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="contiguous"):
        tnative.sum_into(np.zeros((4, 4), np.float32)[:, ::2], np.zeros(8, np.float32))


def test_sum_into(monkeypatch):
    rng = np.random.default_rng(10)
    src = rng.normal(size=(300, 701)).astype(np.float32)
    dst = rng.normal(size=(300, 701)).astype(np.float32)
    want = dst + src
    got = dst.copy()
    assert tnative.sum_into(got, src) is got
    np.testing.assert_array_equal(got, want)
    plain = dst.copy()
    _plain(monkeypatch, tnative.sum_into, plain, src)
    np.testing.assert_array_equal(plain, want)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    """No numpy fallback: a compiler that fails (or is absent) raises, and
    so does every kernel call that needs the library."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    bad = tmp_path / "cc"
    bad.write_text("#!/bin/sh\necho 'error: the compiler broke' >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CXX", str(bad))
    with pytest.raises(RuntimeError, match="(?s)native build failed.*the compiler broke"):
        tnative.available()
    with pytest.raises(RuntimeError, match="native build failed"):
        tnative.normalize_u8_batch(np.zeros((1, 2, 2, 3), np.uint8), MEAN, STD)
    assert not list((tmp_path / "native").glob("*.so*"))  # no partial library
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native build failed"):
        tnative.available()


def test_both_libraries_live_in_one_process():
    """The port's and the JAX package's libraries export the same ``dls_*``
    symbols; loaded ``RTLD_LOCAL``, each call reaches its own."""
    assert jnative.available() and tnative.available()
    assert tnative._load()._name != jnative._load()._name
    img = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    np.testing.assert_array_equal(tnative.normalize_u8_batch(img, MEAN, STD),
                                  jnative.normalize_u8_batch(img, MEAN, STD))


def test_a_first_load_from_many_threads_takes_the_library_in_each(monkeypatch):
    """The load is locked: threads that call while another loads wait for
    the library, none takes a plain version (the JAX package's unlocked
    load lets such a thread take numpy's resize)."""
    import threading

    monkeypatch.setattr(tnative, "_lib", None)
    img = np.random.default_rng(11).uniform(0, 255, (41, 37, 3)).astype(np.float32)
    want = jnative.resize_bilinear(img, (19, 23))
    outs = [None] * 8
    start = threading.Barrier(8)

    def run(i):
        start.wait()
        outs[i] = tnative.resize_bilinear(img, (19, 23))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for out in outs:
        np.testing.assert_array_equal(out, want)
