"""The port's data parallelism on the CPU: gloo ranks against one process and against JAX.

``parallel/mesh.py:spawn`` runs the rank functions of ``tests/torch_dist_workers.py`` in 2
and 4 processes (one torch thread each) that meet over gloo; the JAX references are computed
here and handed in as numpy arrays. At JAX's sizes (``tests/test_parallel.py``: piv v1,
8x32x32, Adam at lr 1e-4), the N-rank step must equal:

- JAX's step jitted over ``make_mesh(4)`` (8 virtual CPU devices, ``tests/conftest.py``):
  loss within 1e-5, every parameter within 1e-6 (JAX's own tolerances);
- the port's one-process step on the global batch: float32 loss within 1e-6 relative and
  every parameter within 1e-7 (measured: 1.3e-8); with the augmentation pipeline (the
  draws of the global batch, split by rows) and with remat. Mixed bf16: the loss within
  1e-5 relative, and the gradients as close to the one-process float32 step's as the
  one-process bf16 step's are (``training/precision.py:grad_relation``: within twice its
  error, whole, median and worst parameter). Not two bf16 ulps of each parameter's largest
  gradient: each rank rounds its bf16 weight gradients before the ranks' are summed, and a
  bias gradient that cancels over the pixels then moves by several of its own ulps (7 at
  one of v1's here).

Every rank ends with rank 0's parameters bit for bit. The eval step, ``estimate(mesh=...)``
with a padded partial batch, the loaders' rank rows and the ``trainer`` and ``run`` CLIs over
two ranks are held to one process too.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from piv_liteflownet_tpu_torch.data.datasets import get_transform
from piv_liteflownet_tpu_torch.data.loader import BatchLoader
from piv_liteflownet_tpu_torch.data.piv_gen import make_dataset_dir
from piv_liteflownet_tpu_torch.data.transforms import draw_params
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.factory import PIV_V1, piv_liteflownet
from piv_liteflownet_tpu_torch.parallel import mesh as M
from piv_liteflownet_tpu_torch.parallel.train_step import make_eval_step, make_train_step
from piv_liteflownet_tpu_torch.training.loss import piv_loss
from piv_liteflownet_tpu_torch.training.optim import make_optimizer
from piv_liteflownet_tpu_torch.utils.flow_io import read_flow

JAX_LOSS_ATOL, JAX_PARAM_ATOL = 1e-5, 1e-6  # tests/test_parallel.py
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-7  # the port's N ranks against its one process, float32
FLOW_ATOL = 1e-6  # px: estimate(mesh) and run --num_devices against one process


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Spawned ranks take the parent's threads shared out: one each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w, 3), dtype=np.float32), rng.random((b, h, w, 3), dtype=np.float32),
            rng.standard_normal((b, h, w, 2)).astype(np.float32))


BATCH = _batch(8, 32, 32)
PIPE_BATCH = _batch(8, 48, 48, seed=1)
PIPE = get_transform(crop_size=(32, 32), mode="train")
UNEVEN = [slice(0, 2), slice(2, 3)]  # a batch of 3 over 2 ranks, rows weighted


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's piv v1 params (torch layout) and one step of its 4-device mesh train step."""
    import jax
    import jax.numpy as jnp

    from piv_liteflownet_tpu.models.factory import piv_liteflownet as jpiv
    from piv_liteflownet_tpu.parallel.mesh import data_sharding, make_mesh, replicated
    from piv_liteflownet_tpu.parallel.train_step import TrainState, make_train_step as jstep
    from piv_liteflownet_tpu.training.loss import piv_loss as jloss
    from piv_liteflownet_tpu.training.optim import make_optimizer as jopt

    model = jpiv(version=1)
    tx, _ = jopt(model.params, 1, lr=1e-4)
    mesh = make_mesh(4)
    step = jstep(model.cfg, jloss(version=1), tx, mesh=mesh)
    params = jax.tree.map(jnp.array, model.params)
    state = jax.device_put(TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)), replicated(mesh))
    put = lambda a: jax.device_put(jnp.asarray(a), data_sharding(mesh))  # noqa: E731
    state, metrics = step(state, *(put(a) for a in BATCH), jax.random.PRNGKey(0))
    start = {k: v.numpy() for k, v in from_jax_params(PIV_V1, {k: np.asarray(v) for k, v in model.params.items()}).items()}
    after = {k: v.numpy() for k, v in from_jax_params(PIV_V1, {k: np.asarray(v) for k, v in state.params.items()}).items()}
    return {"state": start, "params": after, "loss": float(metrics["loss"]), "epe": float(metrics["epe"])}


@pytest.fixture(scope="module")
def state_v2():
    return {k: v.numpy() for k, v in piv_liteflownet(version=2, seed=3, device="cpu").state_dict().items()}


def _calls(state, state_v2, uneven: bool) -> dict:
    return {
        "float32": ("train_case", ("piv", 1, state, BATCH), {}),
        "bf16": ("train_case", ("piv", 1, state, BATCH), {"compute_dtype": torch.bfloat16}),
        "pipeline": ("train_case", ("piv", 1, state, PIPE_BATCH), {"pipeline": PIPE, "seed": 5}),
        "remat": ("train_case", ("piv", 1, state, BATCH), {"remat": True}),
        "v2 bf16 remat": ("train_case", ("piv", 2, state_v2, BATCH), {"compute_dtype": torch.bfloat16, "remat": True}),
        "v2 float32": ("train_case", ("piv", 2, state_v2, BATCH), {}),
        "eval": ("eval_case", (state, BATCH), {}),
        "eval 3": ("eval_case", (state, tuple(a[:3] for a in BATCH)), {"rows": UNEVEN if uneven else None}),
        "estimate 3": ("estimate_case", (state, BATCH[0][:3], BATCH[1][:3]), {}),
    }


@pytest.fixture(scope="module")
def runs(jax_ref, state_v2):
    """Each rank's result of each case, keyed by the number of ranks (1: this process): every
    case over 2 ranks, the float32 step, the eval step and the padded estimate over 4."""

    def spawned(n, calls):
        results = M.spawn(W.many, n, list(calls.values()), threads=1, timeout_s=300)
        return [dict(zip(calls, r)) for r in results]

    state = jax_ref["state"]
    one = _calls(state, state_v2, uneven=False)
    two = {k: c for k, c in _calls(state, state_v2, uneven=True).items() if k != "v2 float32"}
    four = {k: one[k] for k in ("float32", "eval", "estimate 3")}
    return {1: [dict(zip(one, W.many(M.make_mesh(1), list(one.values()))))],
            2: spawned(2, two), 4: spawned(4, four)}


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_jax_mesh_step_and_one_process(runs, jax_ref, n):
    got, one = runs[n][0]["float32"], runs[1][0]["float32"]
    assert abs(got["losses"][0][0] - jax_ref["loss"]) < JAX_LOSS_ATOL
    assert abs(got["losses"][0][1] - jax_ref["epe"]) < JAX_LOSS_ATOL
    assert _max_diff(got["params"], jax_ref["params"]) < JAX_PARAM_ATOL
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    assert _max_diff(got["params"], one["params"]) < PARAM_ATOL
    # every rank started from rank 0's parameters (the others were moved by 1) and ends on them
    assert all(r["float32"]["max_diff_from_rank0"] == 0.0 for r in runs[n])


@pytest.mark.parametrize("case,truth", [("bf16", "float32"), ("v2 bf16 remat", "v2 float32")])
def test_dp_bf16_step_matches_one_process(runs, case, truth):
    from piv_liteflownet_tpu_torch.training.precision import grad_relation

    got, one = runs[2][0][case], runs[1][0][case]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
    grads = [{k: torch.from_numpy(v) for k, v in d["grads"].items()} for d in (got, one, runs[1][0][truth])]
    for part, (err, ref_err, bound) in grad_relation(*grads).items():
        assert err <= bound, (part, err, ref_err)
    assert all(r[case]["max_diff_from_rank0"] == 0.0 for r in runs[2])


def test_dp_step_with_pipeline_draws_the_global_batch(runs):
    """Each rank applies its rows of the draws for the whole batch; draws made for a rank's own
    rows would be other factors (checked here), and the step would not equal one process's."""
    got, one = runs[2][0]["pipeline"], runs[1][0]["pipeline"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    assert _max_diff(got["params"], one["params"]) < PARAM_ATOL
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    whole, own = draw_params(PIPE, 8, 48, 48, gen()), draw_params(PIPE, 4, 48, 48, gen())
    assert not torch.equal(whole["ox"][4:], own["ox"])


def test_dp_step_with_remat_matches_one_process(runs):
    got, one = runs[2][0]["remat"], runs[1][0]["remat"]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    assert _max_diff(got["params"], one["params"]) < PARAM_ATOL
    assert _max_diff(got["params"], runs[2][0]["float32"]["params"]) == 0.0  # remat: the same function


@pytest.mark.parametrize("n", [2, 4])
def test_eval_step_gives_the_global_loss_and_epe(runs, n):
    for rank in range(n):
        for key in ("loss", "epe"):
            assert runs[n][rank]["eval"][key] == pytest.approx(runs[1][0]["eval"][key], rel=LOSS_RTOL)


def test_eval_step_weights_uneven_rows(runs):
    """Rows 2 + 1 of a batch of 3: the ranks' means weighted by their rows are the batch's mean."""
    for rank in range(2):
        for key in ("loss", "epe"):
            assert runs[2][rank]["eval 3"][key] == pytest.approx(runs[1][0]["eval 3"][key], rel=LOSS_RTOL)


@pytest.mark.parametrize("n", [2, 4])
def test_estimate_mesh_pads_a_partial_batch(runs, n):
    """B = 3 is padded to a multiple of N by repeating the last pair; every rank returns [3,H,W,2]."""
    for rank in range(n):
        got = runs[n][rank]["estimate 3"]
        assert got.shape == (3, 32, 32, 2)
        np.testing.assert_allclose(got, runs[1][0]["estimate 3"], atol=FLOW_ATOL)


def test_mesh_helpers_and_uneven_batches():
    mesh = M.make_mesh(1)
    try:
        assert (mesh.axis, mesh.size, mesh.rank) == ("data", 1, 0) and mesh.backend == "gloo"
        assert not mesh.staged("p2p")
        x = torch.arange(6.0).view(3, 2)
        assert torch.equal(M.shard_rows(mesh, x), x) and torch.equal(M.gather_rows(mesh, x), x)
    finally:
        mesh.close()
    assert M.split_rows(8, 4, 3) == slice(6, 8)
    with pytest.raises(ValueError, match="does not split"):
        M.split_rows(3, 2, 0)  # as JAX's device_put onto a data sharding raises
    assert M.devices_to_use(-1, cpu=True) == 1 and M.devices_to_use(3, cpu=True) == 3
    model = piv_liteflownet(device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        make_train_step(model.cfg, piv_loss(), make_optimizer(model, 1), mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        make_eval_step(model.cfg, piv_loss(), mesh="data")


class _Rows:
    """A dataset whose item i is a frame of value i and a flow of value -i."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        im = np.full((2, 2, 3), i, np.float32)
        return (im, im), np.full((2, 2, 2), -i, np.float32)


def test_batch_loader_gives_each_rank_its_rows_of_every_batch():
    one = BatchLoader(_Rows(), batch_size=4, num_workers=0, shuffle=True, seed=3, drop_last=True)
    ranks = [BatchLoader(_Rows(), batch_size=4, num_workers=2, shuffle=True, seed=3, drop_last=True,
                         rank=r, ranks=2) for r in range(2)]
    for loader in [one] + ranks:
        loader.set_epoch(7)
    for whole, *parts in zip(one, *ranks):
        assert np.array_equal(np.concatenate([p[0][0] for p in parts]), whole[0][0])
        assert np.array_equal(np.concatenate([p[1] for p in parts]), whole[1])
    assert len(ranks[0]) == len(one) == 2
    # the last batch of 3 (no drop_last) does not split over 2 ranks
    with pytest.raises(ValueError, match="does not split"):
        list(BatchLoader(_Rows(), batch_size=4, num_workers=0, rank=0, ranks=2))


def test_native_train_loader_gives_each_rank_its_rows(tmp_path):
    from piv_liteflownet_tpu_torch.data.datasets import PIVData
    from piv_liteflownet_tpu_torch.data.loader import native_train_loader_for

    make_dataset_dir(str(tmp_path), n=12, size=(32, 32), seed=2, device="cpu")
    ds = PIVData(root=str(tmp_path), mode="train")
    kw = dict(batch_size=4, num_workers=2, shuffle=True, seed=4, drop_last=True)
    one = native_train_loader_for(ds, **kw)
    ranks = [native_train_loader_for(ds, rank=r, ranks=2, **kw) for r in range(2)]
    py = BatchLoader(ds, rank=1, ranks=2, **kw)
    if one is None:
        pytest.skip("libpivio does not decode this dataset's PNGs here (built without zlib)")
    n = 0
    for whole, *parts, p1 in zip(one, *ranks, py):
        flows = [p[1].numpy().copy() for p in parts]
        assert np.array_equal(np.concatenate(flows), whole[1].numpy())
        assert np.array_equal(flows[1], p1[1])
        n += 1
    assert n == len(one) == 2


# -- the CLIs over two ranks ---------------------------------------------------------------------

def _losses(exp_dir, key="train_batch"):
    rows = [json.loads(line) for line in (Path(exp_dir) / "metrics.jsonl").read_text().splitlines()]
    return [(r["epoch"], r["value"]) for r in rows if r.get("metric", "").startswith(key)]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("piv8")
    make_dataset_dir(str(root), n=8, size=(64, 64), seed=5, device="cpu")  # 6 train, 2 val
    return root


def _argv(dataset, out, *extra):
    return ["--cpu", "--training_dataset_root", str(dataset), "--validation_dataset_root", str(dataset),
            "--batch_size", "2", "--crop_size", "64", "64", "--number_workers", "2",
            "--save", str(out), "--logger_workdir", str(out / "exp"), "--backup_frequency", "1", *extra]


def test_trainer_number_devices_2_trains_as_one_device_and_resumes(dataset, tmp_path):
    from piv_liteflownet_tpu_torch.trainer import main

    one = main(_argv(dataset, tmp_path / "one", "--total_epochs", "2"))
    two = main(_argv(dataset, tmp_path / "two", "--total_epochs", "2", "--number_devices", "2"))
    assert [r["rank"] for r in two] == [0, 1]
    # rank 0 alone writes checkpoints, args.txt and the experiment
    assert two[0]["written"] and not two[1]["written"] and two[1]["experiment_dir"] is None
    names = sorted(p.name for p in (tmp_path / "two").iterdir())
    for want in ("LiteFlowNet_checkpoint", "LiteFlowNet_model_best", "backup_1", "backup_2", "args.txt"):
        assert want in names
    for key in ("train_batch", "val_batch"):
        want, got = _losses(one.experiment.dir, key), _losses(two[0]["experiment_dir"], key)
        assert [e for e, _ in got] == [e for e, _ in want] and len(want) == (6 if key == "train_batch" else 2)
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)
    assert two[0]["step"] == two[1]["step"] == one.state.step == 6
    resumed = main(_argv(dataset, tmp_path / "res", "--total_epochs", "2", "--number_devices", "2",
                         "--resume", str(tmp_path / "two" / "backup_1")))
    for key in ("train_batch", "val_batch"):
        got = _losses(resumed[0]["experiment_dir"], key)
        want = [x for x in _losses(two[0]["experiment_dir"], key) if x[0] == 2]
        assert got == want  # the CPU path is deterministic: bit for bit


def test_run_num_devices_2_writes_the_one_device_files(tmp_path):
    from piv_liteflownet_tpu_torch import run

    indir = W.write_pairs(tmp_path / "in", 5)
    base = ["-m", "piv", "-p", "--cpu", "-i", indir, "--batch_size", "2"]
    run.main(base + ["-o", str(tmp_path / "one")])
    stats = run.main(base + ["-o", str(tmp_path / "two"), "--num_devices", "2"])
    # rank 0 takes pairs 0, 1 and 4 (the first two of each step of 4), rank 1 pairs 2 and 3
    assert stats[0].pairs == 3
    flows = {d: sorted((tmp_path / d / "PIV-LiteFlowNet-en" / "in" / "flow").glob("*.flo")) for d in ("one", "two")}
    assert [p.name for p in flows["two"]] == [p.name for p in flows["one"]] and len(flows["one"]) == 5
    for a, b in zip(flows["two"], flows["one"]):
        np.testing.assert_allclose(read_flow(str(a)), read_flow(str(b)), atol=FLOW_ATOL, err_msg=a.name)
