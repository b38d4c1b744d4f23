"""The port's ``.pivseq`` container (``data/pivseq.py``) and its native reader held to the
JAX package's.

A container the port packs must be byte-equal to the one JAX packs from the
same directory (RGB, mono and 16-bit sources); each package must read the
other's frames and names bit for bit; ``PivseqRun`` must pair and slice as
JAX's does; the port's ``NativeSeqLoader`` and ``seq_read_frame`` must give
JAX's batches, names and frames; ``native_loader_for`` must pick the
sequence loader for a ``PivseqRun``; and the pack CLI's ``main`` must write
JAX's bytes.
"""

import os

import numpy as np
import pytest
from PIL import Image

from piv_liteflownet_tpu.data import native as jnative
from piv_liteflownet_tpu.data import pivseq as jseq
from piv_liteflownet_tpu_torch.data import native, pivseq
from piv_liteflownet_tpu_torch.data.datasets import Run
from piv_liteflownet_tpu_torch.data.loader import native_loader_for


def _make_dir(root, n=6, size=(24, 32), mono=False, pair=False, bits=8, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        if mono:
            top = 255 if bits == 8 else 65535
            arr = (rng.random(size) * top).astype(np.uint8 if bits == 8 else np.uint16)
        else:
            arr = (rng.random((*size, 3)) * 255).astype(np.uint8)
        if pair:
            Image.fromarray(arr).save(os.path.join(root, f"f{i:03d}_img1.png"))
            Image.fromarray(np.roll(arr, 1, axis=1)).save(os.path.join(root, f"f{i:03d}_img2.png"))
        else:
            Image.fromarray(arr).save(os.path.join(root, f"f{i:03d}.png"))
    return str(root)


@pytest.mark.parametrize("kind", ["rgb", "mono", "mono16", "pairs"])
def test_containers_are_byte_equal_and_read_across_packages(tmp_path, kind):
    d = _make_dir(tmp_path / "frames", n=4, mono=kind.startswith("mono"), bits=16 if kind == "mono16" else 8,
                  pair=kind == "pairs")
    ours, theirs = str(tmp_path / "port.pivseq"), str(tmp_path / "jax.pivseq")
    assert pivseq.pack_directory(d, ours) == ours and jseq.pack_directory(d, theirs) == theirs
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    a, b = pivseq.PivseqReader(theirs), jseq.PivseqReader(ours)
    assert (a.h, a.w, a.c, a.dtype_id, a.n_frames, a.names) == (b.h, b.w, b.c, b.dtype_id, b.n_frames, b.names)
    assert a.c == (1 if kind.startswith("mono") else 3) and a.dtype_id == (1 if kind == "mono16" else 0)
    for i, name in enumerate(a.names):
        np.testing.assert_array_equal(a.frame(i), b.frame(i))
        if kind != "mono16":
            want = np.asarray(Image.open(os.path.join(d, name)).convert("RGB"), np.float32) / 255.0
            np.testing.assert_array_equal(a.frame(i), want)
        np.testing.assert_array_equal(native.seq_read_frame(ours, i, a.h, a.w), a.frame(i))
        np.testing.assert_array_equal(native.seq_read_frame(ours, i, a.h, a.w),
                                      jnative.seq_read_frame(theirs, i, a.h, a.w))


def test_write_pivseq_checks_and_converts_as_jax(tmp_path):
    d = _make_dir(tmp_path / "frames", n=2, mono=True)
    files = [os.path.join(d, f) for f in sorted(os.listdir(d))]
    for dtype in ("uint16", "float32"):
        ours, theirs = str(tmp_path / f"p_{dtype}.pivseq"), str(tmp_path / f"j_{dtype}.pivseq")
        assert pivseq.write_pivseq(files, ours, dtype=dtype) == jseq.write_pivseq(files, theirs, dtype=dtype)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    Image.fromarray(np.zeros((5, 5), np.uint8)).save(os.path.join(d, "odd.png"))
    for mod in (pivseq, jseq):
        with pytest.raises(ValueError, match="size"):
            mod.write_pivseq(files + [os.path.join(d, "odd.png")], str(tmp_path / "x.pivseq"))
        with pytest.raises(ValueError):
            mod.write_pivseq([], str(tmp_path / "x.pivseq"))
    (tmp_path / "bad.pivseq").write_bytes(b"NOTASEQ!" + bytes(32))
    with pytest.raises(ValueError, match="not a .pivseq"):
        pivseq.PivseqReader(str(tmp_path / "bad.pivseq"))


@pytest.mark.parametrize("is_pair,start,n", [(False, 0, -1), (True, 0, -1), (False, 2, 3), (True, 1, 2)])
def test_pivseqrun_pairs_and_slices_as_jax_and_run(tmp_path, is_pair, start, n):
    d = _make_dir(tmp_path / "frames", n=5, pair=is_pair)
    out = pivseq.pack_directory(d)
    got = pivseq.PivseqRun(out, is_pair=is_pair, n_images=n, start_at=start)
    want = jseq.PivseqRun(out, is_pair=is_pair, n_images=n, start_at=start)
    run = Run(d, is_pair=is_pair, n_images=n, start_at=start)
    assert got.pairs == want.pairs == [tuple(map(os.path.basename, p)) for p in run.pairs]
    assert got.index_pairs == want.index_pairs and len(got) == len(run) > 0
    for k in range(len(got)):
        (g1, g2), gname = got[k]
        (r1, r2), rname = run[k]
        assert gname == os.path.basename(rname)
        np.testing.assert_array_equal(g1, r1)
        np.testing.assert_array_equal(g2, r2)


@pytest.mark.parametrize("is_pair", [False, True])
def test_native_seq_loader_yields_jax_batches_and_names(tmp_path, is_pair):
    d = _make_dir(tmp_path / "frames", n=7, mono=True, pair=is_pair)
    out = pivseq.pack_directory(d)
    ours, theirs = pivseq.PivseqRun(out, is_pair=is_pair), jseq.PivseqRun(out, is_pair=is_pair)
    port, jax = native.NativeSeqLoader(ours, batch_size=3, threads=2), jnative.NativeSeqLoader(theirs, 3, threads=2)
    assert len(port) == len(jax)
    got = [(np.array(a), np.array(b), names) for (a, b), names in port]
    want = list(jax)
    port.close()
    jax.close()
    assert len(got) == len(want) > 0
    seen = 0
    for (g1, g2, gn), ((w1, w2), wn) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(g1, w1)
        np.testing.assert_array_equal(g2, w2)
        for i in range(len(gn)):
            (r1, r2), name = ours[seen]
            assert name == gn[i]
            np.testing.assert_array_equal(g1[i], r1)
            np.testing.assert_array_equal(g2[i], r2)
            seen += 1
    assert seen == len(ours)


def test_native_loader_for_picks_the_sequence_loader(tmp_path):
    d = _make_dir(tmp_path / "frames", n=4)
    ds = pivseq.PivseqRun(pivseq.pack_directory(d))
    loader = native_loader_for(ds, batch_size=2)
    assert type(loader).__name__ == "NativeSeqLoader" and len(loader) == 2  # 3 pairs
    loader.close()


def test_pack_cli_writes_jax_bytes(tmp_path, capsys):
    d = _make_dir(tmp_path / "frames", n=3)
    out = str(tmp_path / "packed.pivseq")
    pivseq.main([d, out])
    assert "packed 3 frames 24x32x3 uint8" in capsys.readouterr().out
    jseq.main([d, str(tmp_path / "jax.pivseq")])
    assert open(out, "rb").read() == open(str(tmp_path / "jax.pivseq"), "rb").read()
    pivseq.main([d])  # default: <input>.pivseq
    assert pivseq.PivseqReader(d + ".pivseq").n_frames == 3
