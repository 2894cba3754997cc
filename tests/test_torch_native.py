"""The port's native host runtime (``oryon_tpu_torch/utils/native.py``, its
own copy of the C++ source) against the JAX package's library
(``oryon_tpu.utils.native``) on the same arrays: byte for byte, for the run
-length codes, both resizes and the routed ``data/augment.py`` resizes.  The
numpy plain versions are held beside them (exact, and the bilinear one to
1 LSB: it rounds an f64 blend half to even).  Inputs come from
``np.random.RandomState`` seeds.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from oryon_tpu.utils import native as jn
from oryon_tpu_torch.utils import native as tn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    assert jn.available(), "the JAX package's native library did not build"


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


RLE_MASKS = {
    "random": lambda rs: (rs.rand(61, 83) > 0.6).astype(np.uint8),
    "ones": lambda rs: np.ones((7, 9), np.uint8),
    "zeros": lambda rs: np.zeros((5, 4), np.uint8),
    "empty": lambda rs: np.zeros((0, 6), np.uint8),
}


@pytest.mark.parametrize("case", sorted(RLE_MASKS))
def test_rle_matches_jax(case):
    mask = RLE_MASKS[case](np.random.RandomState(1))
    runs = tn.rle_encode(mask)
    _same(runs, jn.rle_encode(mask))
    _same(runs, tn.rle_encode_plain(mask))
    _same(tn.rle_decode(runs, mask.shape), jn.rle_decode(runs, mask.shape))
    _same(tn.rle_decode(runs, mask.shape), mask)
    _same(tn.rle_decode_plain(runs, mask.shape), mask)


BILINEAR = {   # case -> (input shape, output size)
    "view 480x640x3 to 224": ((480, 640, 3), (224, 224)),
    "mask 480x640 to 224": ((480, 640), (224, 224)),
    "up 11x16x3 to 37x50": ((11, 16, 3), (37, 50)),
    "up 1x1x3 to 5x7": ((1, 1, 3), (5, 7)),
    "C=1": ((30, 41, 1), (17, 23)),
    "C=4": ((30, 41, 4), (17, 23)),
}


@pytest.mark.parametrize("case", sorted(BILINEAR))
def test_resize_bilinear_matches_jax(case):
    shape, out_hw = BILINEAR[case]
    img = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    got = tn.resize_bilinear_u8(img, out_hw)
    _same(got, jn.resize_bilinear_u8(img, out_hw))
    plain = tn.resize_bilinear_plain(img, out_hw)
    assert plain.shape == got.shape and np.abs(plain.astype(int) - got).max() <= 1


@pytest.mark.parametrize("ndim", [2, 3])
def test_resize_nearest_matches_jax(ndim):
    """2-D through the library, 3-D through the plain version (the C entry is
    single-channel), as in the JAX binding."""
    shape = (48, 64) if ndim == 2 else (48, 64, 3)
    img = np.random.RandomState(3).randint(0, 256, shape).astype(np.uint8)
    for out_hw in ((17, 29), (96, 100)):
        got = tn.resize_nearest_u8(img, out_hw)
        _same(got, jn.resize_nearest_u8(img, out_hw))
        _same(got, tn.resize_nearest_plain(img, out_hw))


@pytest.mark.parametrize("fn", ["resize_bilinear", "resize_nearest"])
def test_routed_augment_resizes_match_jax(fn):
    """``data/augment.py`` sends uint8 views and 2-D uint8 masks through the
    library: the JAX package's functions give the same bytes."""
    from oryon_tpu.data import augment as ja
    from oryon_tpu_torch.data import augment as ta

    rs = np.random.RandomState(4)
    for img in (rs.randint(0, 256, (120, 160, 3)).astype(np.uint8),
                (rs.rand(120, 160) > 0.5).astype(np.uint8)):
        _same(getattr(ta, fn)(img, (56, 56)), getattr(ja, fn)(img, (56, 56)))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: the first call raises, naming the command, and returns
    no numpy output."""
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "/nonexistent")
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(RuntimeError, match="/nonexistent"):
        tn.resize_bilinear_u8(img, (4, 4))
    with pytest.raises(RuntimeError, match="/nonexistent"):
        tn.rle_encode(img)
    assert tn._lib is None and os.listdir(tmp_path) == []


def test_edited_source_is_rebuilt(monkeypatch, tmp_path):
    """The library is named by the source's hash: an unchanged source is
    reused, an edited one built anew."""
    src = tmp_path / "oryon_native.cpp"
    src.write_text(open(tn.SOURCE).read())
    build = tmp_path / "build"
    monkeypatch.setattr(tn, "SOURCE", str(src))
    monkeypatch.setattr(tn, "BUILD_DIR", str(build))
    built = []
    for edit in ("", "", "// edited\n"):
        src.write_text(src.read_text() + edit)
        monkeypatch.setattr(tn, "_lib", None)
        tn.library()
        built.append(sorted(os.listdir(build)))
    assert len(built[0]) == 1 and built[1] == built[0]
    assert len(built[2]) == 2 and built[0][0] in built[2]


_BUILD_IN_CHILD = """
import sys
sys.path.insert(0, {root!r})
from oryon_tpu_torch.utils import native
native.BUILD_DIR = {build!r}
print(native.resize_bilinear_u8(native.np.full((4, 4), 7, native.np.uint8), (2, 2)).sum())
"""


@pytest.mark.parametrize("workers", ["threads", "processes"])
def test_concurrent_first_calls_build_once(monkeypatch, tmp_path, workers):
    """Sixteen threads (one lock) or four processes (a unique temporary name,
    then ``os.replace``) make the first call at once into an empty build
    directory: every call answers, one library is left and no temporary."""
    build = str(tmp_path / "build")
    if workers == "threads":
        monkeypatch.setattr(tn, "_lib", None)
        monkeypatch.setattr(tn, "BUILD_DIR", build)
        out, libs = [], []
        barrier = threading.Barrier(16)

        def call():
            barrier.wait(timeout=30)
            libs.append(tn.library())
            out.append(int(tn.resize_bilinear_u8(np.full((4, 4), 7, np.uint8), (2, 2)).sum()))

        threads = [threading.Thread(target=call) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert out == [28] * 16 and len({id(lib) for lib in libs}) == 1
    else:
        code = _BUILD_IN_CHILD.format(root=ROOT, build=build)
        procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for _ in range(4)]
        res = [p.communicate(timeout=180) for p in procs]
        assert [p.returncode for p in procs] == [0] * 4, res
        assert [o.strip() for o, _ in res] == ["28"] * 4
    assert len(os.listdir(build)) == 1 and os.listdir(build)[0].endswith(".so")
