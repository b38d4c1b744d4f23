"""The port's weight converter, dataset packers and split tool, and the trainer's
``--native_io``, held to the JAX package.

``rename_caffe_keys`` must give JAX's key order; ``validate_params`` must
raise where JAX's does (a missing or extra key, a wrong shape); the converter
CLI must round-trip ``npz2torch`` -> ``torch2npz`` bit-equal and take a Caffe
export. An HDF5 store the port writes must read back through both packages'
``PIVH5``, and ``extract_dataset`` must give JAX's file lists.
``trainer --native_io --cpu`` must train on the native loader with the
Python loader's losses and weights, bit for bit (the same batches in the same
order). Whole models run here, so torch uses one thread.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import convert as convert_cli
from piv_liteflownet_tpu_torch.data import split as psplit
from piv_liteflownet_tpu_torch.data import write_data as pwrite
from piv_liteflownet_tpu_torch.data.datasets import PIVH5
from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir
from piv_liteflownet_tpu_torch.models import convert as C
from piv_liteflownet_tpu_torch.models.factory import PIV_V1, PIV_V2, config
from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; these tests use one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_cfg(family, version):
    """JAX's ``ModelConfig`` of the same model (no params built)."""
    from piv_liteflownet_tpu.models.liteflownet import ModelConfig

    cfg = config(family, version)
    return ModelConfig(version=cfg.version, starting_scale=cfg.starting_scale, lowest_level=cfg.lowest_level,
                       rgb_mean=cfg.rgb_mean)


@pytest.mark.parametrize("family,version", [("piv", 1), ("piv", 2), ("hui", 1)])
def test_rename_caffe_keys_gives_jax_s_key_order(family, version):
    from piv_liteflownet_tpu.models import convert as jconvert

    cfg = config(family, version)
    want = jconvert.expected_keys(_jax_cfg(family, version))
    assert C.expected_keys(cfg) == want == list(LiteFlowNet(cfg).state_dict())
    caffe = {}
    for i, k in enumerate(want):
        caffe[f"layer{i:03d}.{k.rsplit('.', 1)[1]}"] = i
        caffe[f"layer{i:03d}.blob_meta"] = -1  # neither a weight nor a bias: dropped
    got = C.rename_caffe_keys(cfg, caffe)
    assert got == jconvert.rename_caffe_keys(_jax_cfg(family, version), caffe)
    assert list(got) == want and list(got.values()) == list(range(len(want)))
    del caffe["layer000.weight"]
    for fn, c in ((C.rename_caffe_keys, cfg), (jconvert.rename_caffe_keys, _jax_cfg(family, version))):
        with pytest.raises(ValueError, match="tensors but model expects"):
            fn(c, caffe)


def test_validate_params_raises_where_jax_s_does():
    from piv_liteflownet_tpu.models import convert as jconvert

    sd = LiteFlowNet(PIV_V1).state_dict()
    jparams = C.to_jax_params(PIV_V1, sd)
    jcfg = _jax_cfg("piv", 1)
    C.validate_params(PIV_V1, sd)
    jconvert.validate_params(jcfg, jparams)
    name = "NetC.conv1.0.weight"
    cases = {"missing": (lambda d: d.pop(name)), "extra": (lambda d: d.__setitem__("extra.weight", d[name])),
             "shape": (lambda d: d.__setitem__(name, d[name][..., :1]))}
    for case, edit in cases.items():
        ours, theirs = dict(sd), dict(jparams)
        edit(ours)
        edit(theirs)
        for fn, c, d in ((C.validate_params, PIV_V1, ours), (jconvert.validate_params, jcfg, theirs)):
            with pytest.raises(ValueError, match="mismatch" if case != "shape" else "shape"):
                fn(c, d)
    with pytest.raises(ValueError, match="mismatch"):
        C.validate_params(PIV_V2, sd)


def test_converter_round_trips_bit_equal(tmp_path, capsys):
    model = LiteFlowNet(PIV_V1)
    model.init_parameters(torch.Generator().manual_seed(4))
    params = C.to_jax_params(PIV_V1, model.state_dict())  # JAX's layouts, as its .npz holds them
    npz = str(tmp_path / "jax.npz")
    np.savez(npz, **params)
    convert_cli.main(["--mode", "npz2torch", "-i", npz, "-o", str(tmp_path / "w.paramOnly")])
    convert_cli.main(["--mode", "torch2npz", "-i", str(tmp_path / "w.paramOnly"), "-o", str(tmp_path / "back.npz")])
    assert "wrote torch state dict" in capsys.readouterr().out
    with np.load(str(tmp_path / "back.npz")) as back:
        assert sorted(back.files) == sorted(params)
        for k, v in params.items():
            np.testing.assert_array_equal(back[k], v)
    sd = torch.load(str(tmp_path / "w.paramOnly"), weights_only=True)
    assert list(sd) == C.expected_keys(PIV_V1)
    caffe = {f"blob{i}.{k.rsplit('.', 1)[1]}": v for i, (k, v) in enumerate(sd.items())}
    torch.save(caffe, str(tmp_path / "caffe.pt"))
    convert_cli.main(["--mode", "caffe", "-i", str(tmp_path / "caffe.pt"), "-o", str(tmp_path / "c.paramOnly")])
    again = torch.load(str(tmp_path / "c.paramOnly"), weights_only=True)
    assert list(again) == list(sd) and all(torch.equal(again[k], sd[k]) for k in sd)
    with pytest.raises(KeyError, match="missing"):  # v1 params for v2
        convert_cli.main(["--mode", "npz2torch", "-v", "2", "-i", npz, "-o", str(tmp_path / "x")])


def test_hdf5_written_by_the_port_reads_back_through_both_packages(tmp_path):
    from piv_liteflownet_tpu.data import write_data as jwrite
    from piv_liteflownet_tpu.data.datasets import PIVH5 as JPIVH5

    root = tmp_path / "ds"
    make_dataset_dir(str(root), n=4, size=(32, 48), seed=1, device="cpu")
    assert pwrite.samples_from_manifest(str(root), str(root / "train.json")) == \
        jwrite.samples_from_manifest(str(root), str(root / "train.json"))
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    pwrite.write_hdf5(str(root), ours)
    jwrite.write_hdf5(str(root), theirs)
    for mode, n in (("train", 3), ("val", 1)):
        readers = [PIVH5(ours, mode), JPIVH5(ours, mode), PIVH5(theirs, mode)]
        assert [len(r) for r in readers] == [n] * 3
        for i in range(n):
            (a1, a2), af = readers[0][i]
            for r in readers[1:]:
                (b1, b2), bf = r[i]
                for x, y in ((a1, b1), (a2, b2), (af, bf)):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        for r in readers:
            r.close()
    with pytest.raises(ImportError, match="lmdb"):
        pwrite.write_lmdb(str(root), str(tmp_path / "x.lmdb"))


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "splits": (0.5, 0.25, 0.25), "fmt": ("json", "csv", "txt")},
                                {"relative": False}])
def test_extract_dataset_gives_jax_s_file_lists(tmp_path, kw):
    from piv_liteflownet_tpu.data import split as jsplit

    root = tmp_path / "ds"
    root.mkdir()
    for i in range(11):
        (root / f"s{i:02d}_flow.flo").write_bytes(b"")
    got = psplit.extract_dataset(str(root), str(tmp_path / "port"), **kw)
    want = jsplit.extract_dataset(str(root), str(tmp_path / "jax"), **kw)
    assert got == want and sum(got.values()) == 11
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for f in os.listdir(tmp_path / "port"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()


def test_trainer_native_io_trains_on_the_python_loaders_batches(tmp_path):
    from piv_liteflownet_tpu_torch import trainer
    from piv_liteflownet_tpu_torch.data.native import NativeTrainLoader
    from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir

    root = tmp_path / "ds"
    make_dataset_dir(str(root), n=6, size=(64, 64), seed=3, device="cpu")  # 4 train pairs: 2 steps of 2
    runs = {}
    for tag, flags in (("python", []), ("native", ["--native_io"])):
        save = tmp_path / tag
        runs[tag] = trainer.main(["--cpu", "--training_dataset_root", str(root), "--validation_dataset_mode", "none",
                                  "--batch_size", "2", "--crop_size", "64", "64", "--total_epochs", "1",
                                  "--number_workers", "2", "--save", str(save),
                                  "--logger_workdir", str(save / "exp"), *flags])
    assert isinstance(runs["native"].loaders["train"], NativeTrainLoader)
    assert not isinstance(runs["python"].loaders["train"], NativeTrainLoader)
    losses = {}
    for tag, tr in runs.items():
        rows = [json.loads(line) for line in (Path(tr.experiment.dir) / "metrics.jsonl").read_text().splitlines()]
        losses[tag] = [r["value"] for r in rows if r.get("metric", "").startswith("train_batch")]
    assert len(losses["native"]) == 2 and losses["native"] == losses["python"]
    for name, t in runs["native"].state.model.state_dict().items():
        assert torch.equal(t, runs["python"].state.model.state_dict()[name]), name
