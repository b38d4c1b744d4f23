"""The port's native I/O (``data/native.py``, its own ``libpivio`` built from
``data/_native/pivio.cpp``) held to the JAX package's ``data/native.py`` and to PIL.

The ``.flo`` codec and the image decoders must be bit-equal to JAX's native
functions, to ``utils/flow_io.py`` and to PIL's ``convert("RGB")`` values over
255 (over 65535 at 16 bits); the three loaders must yield JAX's batches and
names (the training loader over two epochs of its shuffle); ``native_loader_for``
and ``native_train_loader_for`` must pick as JAX's do, case for case, and raise
where the library cannot be built. The ring of host slots must wait on the
fence of a slot before handing it out again. A card-only test holds the
pinned-slot path through ``PrefetchLoader`` to the batches themselves.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from piv_liteflownet_tpu_torch.data import loader as ploader
from piv_liteflownet_tpu_torch.data import native
from piv_liteflownet_tpu_torch.data.datasets import PIVData, Run
from piv_liteflownet_tpu_torch.utils.flow_io import read_flow, write_flow


def _save(path, arr, mode=None, **kw):
    im = Image.fromarray(arr)
    (im.convert(mode) if mode else im).save(path, **kw)
    return str(path)


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _batches(loader):
    """Every batch of a loader as numpy copies (the port's yields are views of its ring)."""
    out = []
    for (im1, im2), meta in loader:
        meta = np.array(meta) if isinstance(meta, torch.Tensor) else meta
        out.append((np.array(im1), np.array(im2), meta if isinstance(meta, list) else np.array(meta)))
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for (g1, g2, gm), (w1, w2, wm) in zip(got, want):
        np.testing.assert_array_equal(g1, w1)
        np.testing.assert_array_equal(g2, w2)
        if isinstance(wm, list):
            assert gm == wm
        else:
            np.testing.assert_array_equal(gm, wm)


def test_flo_codec_is_bit_equal_to_jax_and_python(tmp_path):
    from piv_liteflownet_tpu.data import native as jnative
    rng = np.random.default_rng(0)
    for bands in (2, 3):
        flow = rng.standard_normal((17, 23, bands)).astype(np.float32)
        paths = {k: str(tmp_path / f"{k}{bands}.flo") for k in ("port", "jax", "py")}
        native.flo_write(paths["port"], flow)
        jnative.flo_write(paths["jax"], flow)
        write_flow(flow, paths["py"])
        blobs = {k: open(p, "rb").read() for k, p in paths.items()}
        assert blobs["port"] == blobs["jax"] == blobs["py"]
        np.testing.assert_array_equal(native.flo_read(paths["py"], bands=bands), flow)
        np.testing.assert_array_equal(native.flo_read(paths["jax"], bands=bands),
                                      jnative.flo_read(paths["port"], bands=bands))
        if bands == 2:
            np.testing.assert_array_equal(read_flow(paths["port"]), flow)
    with pytest.raises(IOError):
        native.flo_read(str(tmp_path / "missing.flo"))


def _image_cases(tmp_path):
    rng = np.random.default_rng(6)
    arr = (rng.random((21, 33, 3)) * 255).astype(np.uint8)
    g16 = (rng.random((21, 33)) * 65535).astype(np.uint16)
    return {
        "rgb.png": _save(tmp_path / "rgb.png", arr),
        "gray.png": _save(tmp_path / "gray.png", arr[..., 0]),
        "rgba.png": _save(tmp_path / "rgba.png", np.dstack([arr, arr[..., :1]])),
        "la.png": _save(tmp_path / "la.png", arr[..., 0], mode="LA"),
        "pal.png": _save(tmp_path / "pal.png", arr, mode="P"),
        "gray16.png": _save(tmp_path / "gray16.png", g16),
        "gray.tif": _save(tmp_path / "gray.tif", arr[..., 0]),
        "rgb.tif": _save(tmp_path / "rgb.tif", arr),
        "gray_pb.tif": _save(tmp_path / "gray_pb.tif", arr[..., 0], compression="packbits"),
        "rgb_pb.tif": _save(tmp_path / "rgb_pb.tif", arr, compression="packbits"),
        "gray.pgm": _save(tmp_path / "gray.pgm", arr[..., 1]),
        "rgb.ppm": _save(tmp_path / "rgb.ppm", arr),
    }


def test_image_read_is_bit_equal_to_jax_and_pil(tmp_path):
    from piv_liteflownet_tpu.data import native as jnative
    for name, path in _image_cases(tmp_path).items():
        got = native.image_read(path)
        np.testing.assert_array_equal(got, jnative.image_read(path), err_msg=name)
        if name == "gray16.png":
            want = np.repeat((np.asarray(Image.open(path), np.float32) / 65535.0)[..., None], 3, -1)
        else:
            want = _pil(path)
        assert got.dtype == np.float32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    _save(tmp_path / "bw.png", np.random.default_rng(1).random((8, 8)) > 0.5)  # 1-bit: rejected
    with pytest.raises(IOError):
        native.image_read(str(tmp_path / "bw.png"))


def _pairs(root, n, ext="png", size=(16, 24), mono=False, seed=3):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        for tag in ("img1", "img2"):
            shape = size if mono else (*size, 3)
            _save(os.path.join(root, f"s{i}_{tag}.{ext}"), (rng.random(shape) * 255).astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_native_batch_loader_yields_jax_batches_and_names(tmp_path, ext):
    from piv_liteflownet_tpu.data import native as jnative
    pairs = Run(_pairs(tmp_path / "d", 5, ext), is_pair=True).pairs
    port = native.NativeBatchLoader(pairs, batch_size=2, height=16, width=24, threads=2)
    jax = jnative.NativeBatchLoader(pairs, batch_size=2, height=16, width=24, threads=2)
    assert len(port) == len(jax) == 3
    got, want = _batches(port), _batches(jax)
    port.close()
    jax.close()
    _assert_batches_equal(got, want)
    assert got[-1][0].shape[0] == 1 and got[0][2] == [pairs[0][0], pairs[1][0]]
    np.testing.assert_array_equal(got[0][0][0], _pil(pairs[0][0]))


def _triplets(root, n, size=(16, 24), seed=8):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    trips = []
    for i in range(n):
        p1, p2, pf = (os.path.join(root, f"s{i}_{t}") for t in ("img1.png", "img2.png", "flow.flo"))
        _save(p1, (rng.random(size) * 255).astype(np.uint8))
        _save(p2, (rng.random(size) * 255).astype(np.uint8))
        write_flow(rng.standard_normal((*size, 2)).astype(np.float32), pf)
        trips.append((p1, p2, pf))
    return trips


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_native_train_loader_yields_jax_batches_over_two_epochs(tmp_path, shuffle, drop_last):
    from piv_liteflownet_tpu.data import native as jnative
    trips = _triplets(str(tmp_path), 5)
    kw = dict(batch_size=2, height=16, width=24, fh=16, fw=24, threads=2, shuffle=shuffle, seed=1,
              drop_last=drop_last)
    port, jax = native.NativeTrainLoader(trips, **kw), jnative.NativeTrainLoader(trips, **kw)
    assert len(port) == len(jax) == (2 if drop_last else 3)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax.set_epoch(epoch)
        _assert_batches_equal(_batches(port), _batches(jax))
    port.set_epoch(2)
    (im1, _), flow = next(iter(port))
    first = np.random.default_rng(1 + 2).permutation(5)[0] if shuffle else 0
    np.testing.assert_array_equal(np.array(flow[0]), read_flow(trips[first][2]))
    np.testing.assert_array_equal(np.array(im1[0]), _pil(trips[first][0]))


def test_native_train_loader_equals_the_python_loader_over_pivdata(tmp_path):
    from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir

    make_dataset_dir(str(tmp_path), n=6, size=(32, 32), seed=2, device="cpu")
    ds = PIVData(str(tmp_path), "train")
    for epoch in (1, 2):
        nat = ploader.native_train_loader_for(ds, 2, num_workers=2, shuffle=True, seed=5, drop_last=True)
        py = ploader.BatchLoader(ds, 2, num_workers=2, shuffle=True, seed=5, drop_last=True)
        nat.set_epoch(epoch)
        py.set_epoch(epoch)
        _assert_batches_equal(_batches(nat), _batches(py))


def _gating_datasets(tmp_path):
    rng = np.random.default_rng(4)
    out = {"ppm": _pairs(tmp_path / "ppm", 3, "ppm"), "png": _pairs(tmp_path / "png", 2, "png"),
           "tif": _pairs(tmp_path / "tif", 2, "tif", mono=True), "jpg": _pairs(tmp_path / "jpg", 2, "jpg")}
    bw = tmp_path / "bw"
    bw.mkdir()
    for tag in ("img1", "img2"):
        _save(bw / f"s0_{tag}.png", rng.random((16, 24)) > 0.5)
    out["bw"] = str(bw)
    mixed = _pairs(tmp_path / "mixed", 1, "png")
    _save(os.path.join(mixed, "s1_img1.bmp"), (rng.random((16, 24, 3)) * 255).astype(np.uint8))
    _save(os.path.join(mixed, "s1_img2.bmp"), (rng.random((16, 24, 3)) * 255).astype(np.uint8))
    out["mixed"] = mixed
    return out


def test_native_loader_for_gates_as_jax_does(tmp_path):
    from piv_liteflownet_tpu.data import loader as jloader
    from piv_liteflownet_tpu.data.datasets import Run as JRun

    for name, root in _gating_datasets(tmp_path).items():
        port = ploader.native_loader_for(Run(root, is_pair=True), 2)
        jax = jloader.native_loader_for(JRun(root, is_pair=True), 2)
        assert (port is None) == (jax is None), name
        assert (port is None) == (name in ("jpg", "bw", "mixed")), name
        if port is not None:
            assert type(port).__name__ == type(jax).__name__ == "NativeBatchLoader"
            _assert_batches_equal(_batches(port), _batches(jax))
            port.close()
            jax.close()
    assert ploader.native_loader_for(Run(str(tmp_path / "bw"), is_pair=False), 2) is None
    empty = tmp_path / "empty"
    empty.mkdir()
    assert ploader.native_loader_for(Run(str(empty)), 2) is None


def test_native_train_loader_for_gates_as_jax_does(tmp_path):
    from piv_liteflownet_tpu.data import loader as jloader
    trips = _triplets(str(tmp_path / "t"), 3)

    class DS:
        def __init__(self, samples):
            self.samples = samples

    cases = {"png": DS(trips), "pairs only": DS([t[:2] for t in trips]), "no samples": DS([]),
             "bad flo": DS([(trips[0][0], trips[0][1], trips[0][0])]),
             "jpg": DS([(t[0][:-3] + "jpg",) + t[1:] for t in trips])}
    for name, ds in cases.items():
        port = ploader.native_train_loader_for(ds, 2, shuffle=False, drop_last=False)
        jax = jloader.native_train_loader_for(ds, 2, shuffle=False, drop_last=False)
        assert (port is None) == (jax is None) == (name != "png"), name
    assert ploader.native_train_loader_for(object(), 2) is None


def test_native_io_raises_with_the_compilers_message_when_the_build_fails(tmp_path, monkeypatch):
    bad = tmp_path / "pivio.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    root = _pairs(tmp_path / "d", 1, "ppm")
    with pytest.raises(RuntimeError, match="error"):
        ploader.native_loader_for(Run(root, is_pair=True), 2)
    with pytest.raises(RuntimeError, match="error"):
        ploader.native_train_loader_for(object(), 2)
    assert not list((tmp_path / "build").glob("*.so")) and not list((tmp_path / "build").glob("*.tmp"))


def test_build_is_named_by_the_source_hash_and_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    first = native.build()
    again = native.build()
    assert first.rebuilt and not again.rebuilt and first.path == again.path
    assert first.path.parent == tmp_path / "build" and first.png == native.zlib_header_found()
    assert first.compiler.startswith("g++")
    src = tmp_path / "pivio.cpp"
    src.write_text(native.SRC.read_text() + "\n// another source\n")
    monkeypatch.setattr(native, "SRC", src)
    assert native.build().path != first.path


def test_without_zlib_png_is_left_to_the_python_loader(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "zlib_header_found", lambda: False)
    monkeypatch.setattr(native, "_lib", None)
    res = native.build()
    assert not res.png and not native.has_png()
    png, ppm = _pairs(tmp_path / "png", 2, "png"), _pairs(tmp_path / "ppm", 2, "ppm")
    with pytest.raises(IOError):
        native.image_read(os.path.join(png, "s0_img1.png"))
    assert ploader.native_loader_for(Run(png, is_pair=True), 2) is None
    loader = ploader.native_loader_for(Run(ppm, is_pair=True), 2)
    assert loader is not None
    loader.close()


def test_slot_ring_waits_on_a_slots_fence_before_handing_it_out_again():
    calls = []

    class Event:
        def __init__(self, name):
            self.name = name

        def synchronize(self):
            calls.append(self.name)

    ring = native.SlotRing([(2, 3)], n=2)
    a = ring.take()
    ring.fence(Event("a"))
    b = ring.take()
    assert calls == [] and a[0].data_ptr() != b[0].data_ptr()
    ring.fence(Event("b"))
    assert ring.take()[0].data_ptr() == a[0].data_ptr() and calls == ["a"]
    assert ring.take()[0].data_ptr() == b[0].data_ptr() and calls == ["a", "b"]
    ring.take()  # no fence was set on the slot this time
    assert calls == ["a", "b"]


def test_prefetch_loader_on_the_cpu_copies_the_ring_slots(tmp_path):
    from piv_liteflownet_tpu.data import native as jnative
    pairs = Run(_pairs(tmp_path / "d", 6, "ppm"), is_pair=True).pairs
    want = _batches(jnative.NativeBatchLoader(pairs, 1, 16, 24, threads=2))
    loader = native.NativeBatchLoader(pairs, 1, 16, 24, threads=2)
    got = list(ploader.PrefetchLoader(loader, "cpu", prefetch=3, fence=loader.fence))
    _assert_batches_equal([(a.numpy(), b.numpy(), n) for (a, b), n in got], want)


def test_native_loaders_raise_naming_a_bad_file(tmp_path):
    """A frame that does not decode, a frame of another size than the loader's, or a flow of
    another size, fails its batch with the file's name: nothing is cropped, padded or left
    zero in its place."""
    pairs = Run(_pairs(tmp_path / "d", 4, "png"), is_pair=True).pairs
    blob = open(pairs[1][1], "rb").read()
    open(pairs[1][1], "wb").write(blob[:len(blob) // 2])
    with pytest.raises(IOError, match="cannot decode .*s1_img2.png"):
        _batches(native.NativeBatchLoader(pairs, 2, 16, 24, threads=2))
    _save(pairs[1][1], np.zeros((16, 20, 3), np.uint8))
    with pytest.raises(IOError, match="s1_img2.png is 16x20; the frames of this loader are 16x24"):
        _batches(native.NativeBatchLoader(pairs, 2, 16, 24, threads=2))
    trips = _triplets(str(tmp_path / "t"), 3)
    write_flow(np.zeros((16, 23, 2), np.float32), trips[2][2])
    with pytest.raises(IOError, match="s2_flow.flo is 16x23; the flows of this loader are 16x24"):
        _batches(native.NativeTrainLoader(trips, 2, 16, 24, 16, 24, threads=2))


class _SlowStreams(torch.cuda.Stream if torch.cuda.is_available() else object):
    """``torch.cuda.Stream`` whose new streams start with ``CYCLES`` of sleep: every copy that
    ``PrefetchLoader`` enqueues on its side stream runs only after it."""

    CYCLES = 2_000_000_000  # about a second

    def __new__(cls, *args, **kwargs):
        stream = super().__new__(cls, *args, **kwargs)
        if not kwargs:  # a new stream, not a wrapper of an existing one
            with torch.cuda.stream(stream):
                torch.cuda._sleep(cls.CYCLES)
        return stream


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_pinned_slots_reach_the_card_intact(tmp_path, monkeypatch):
    """The copies to the card are held back on their stream while the loader runs ahead over a
    ring of 4 slots: with the fence every batch arrives intact; without it a later batch
    overwrites a slot before its copy has read it."""
    pairs = Run(_pairs(tmp_path / "d", 12, "ppm", size=(64, 96)), is_pair=True).pairs
    want = _batches(native.NativeBatchLoader(pairs, 1, 64, 96, threads=2))
    monkeypatch.setattr(torch.cuda, "Stream", _SlowStreams)
    got = {}
    for fenced in (True, False):
        loader = native.NativeBatchLoader(pairs, 1, 64, 96, threads=2)
        assert loader.ring.slots[0][0].is_pinned()
        fence = loader.fence if fenced else None
        kept = list(ploader.PrefetchLoader(loader, "cuda", prefetch=8, fence=fence))  # no sync meanwhile
        torch.cuda.synchronize()
        got[fenced] = [(im1.cpu().numpy(), im2.cpu().numpy(), names) for (im1, im2), names in kept]
        loader.close()
    _assert_batches_equal(got[True], want)
    assert any(not np.array_equal(g[0], w[0]) for g, w in zip(got[False], want))
