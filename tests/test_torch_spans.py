"""The program's spans (``utils/profiling.py:span``) on the CPU: off without a profiler, the
table's names nested as the layers are under one, on their own threads in the loader, and
outputs bit-equal with and without a profiler."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from piv_liteflownet_tpu_torch import piv_liteflownet
from piv_liteflownet_tpu_torch.data.datasets import get_transform
from piv_liteflownet_tpu_torch.data.loader import PrefetchLoader
from piv_liteflownet_tpu_torch.inference import estimate
from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_train_step
from piv_liteflownet_tpu_torch.training.loss import piv_loss
from piv_liteflownet_tpu_torch.training.optim import make_optimizer
from piv_liteflownet_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; these tests use one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    return {v: piv_liteflownet(version=v, seed=v, device="cpu") for v in (1, 2)}


def _frames(b=1, h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((b, h, w, 3), dtype=np.float32), 0, 1)
    return img1, img2


def _train_batch(b=1, h=64, w=64, seed=1):
    img1, img2 = _frames(b, h, w, seed)
    flow = (2.0 * np.random.default_rng(seed).standard_normal((b, h, w, 2))).astype(np.float32)
    return img1, img2, flow


def _step(version=1):
    model = piv_liteflownet(version=version, seed=5, device="cpu")
    opt = make_optimizer(model, model.cfg.lowest_level)
    step = make_train_step(model.cfg, piv_loss(), opt, pipeline=get_transform(crop_size=(64, 64), mode="train"))
    return TrainState(model, opt), step


def _spans(prof):
    """``(name, thread, start, end)`` of the program's spans, in start order."""
    out = [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("piv.")]
    return sorted(out, key=lambda s: (s[2], -s[3]))


def _inside(a, b):
    return b[2] <= a[2] and a[3] <= b[3]


def test_span_is_one_shared_null_context_without_a_profiler():
    assert profiling.span(profiling.ESTIMATE) is profiling.span(profiling.STEP)
    with profiling.span(profiling.MODEL) as entered:
        assert entered is None
    assert profiling.level_spans(3) == ("piv.L3.NetC_ext", "piv.L3.NetE-M", "piv.L3.NetE-S", "piv.L3.NetE-R")


def test_without_a_profiler_no_span_enters_record_function(models, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    estimate(models[2], *_frames())
    state, step = _step()
    step(state, *_train_batch(), 3)
    batches = [(_frames(1, 8, 8, i), i) for i in range(3)]
    assert [k for _, k in PrefetchLoader(batches, "cpu")] == [0, 1, 2]


@pytest.mark.parametrize("version", [1, 2])
def test_estimate_emits_the_spans_nested_and_the_same_flow(models, version):
    model = models[version]
    img1, img2 = _frames(seed=version)
    plain = estimate(model, img1, img2, tensor=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = estimate(model, img1, img2, tensor=True)
    assert torch.equal(plain, traced)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    levels = model.cfg.levels
    want = {"piv.estimate", "piv.estimate.in", "piv.estimate.out", "piv.model", "piv.NetC", "piv.pyramid"}
    want |= {n for lv in levels for n in profiling.level_spans(lv) if lv <= 2 or "NetC_ext" not in n}
    assert set(names) == want
    assert names.count("piv.NetC") == 2
    assert names.count(profiling.level_spans(levels[0])[0]) == 2  # one a frame
    by = {s[0]: s for s in spans}
    assert _inside(by["piv.model"], by["piv.estimate"])
    assert by["piv.estimate.in"][3] <= by["piv.model"][2] and by["piv.model"][3] <= by["piv.estimate.out"][2]
    for s in spans:
        if s[0].startswith("piv.L") or s[0] in ("piv.NetC", "piv.pyramid"):
            assert _inside(s, by["piv.model"]), s[0]
    # the levels run coarse to fine, M then S then R
    order = [n for n in names if n.startswith("piv.L") and "NetC_ext" not in n]
    assert order == [n for lv in reversed(levels) for n in profiling.level_spans(lv)[1:]]


def test_train_step_emits_its_phases_in_order_and_the_same_update():
    batch = _train_batch()
    (plain_state, plain_step), (state, step) = _step(), _step()
    _, plain = plain_step(plain_state, *batch, 11)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, traced = step(state, *batch, 11)
    assert torch.equal(plain["loss"], traced["loss"])
    for (n, p), q in zip(state.model.named_parameters(), plain_state.model.parameters()):
        assert torch.equal(p, q), n
    spans = _spans(prof)
    (root,) = [s for s in spans if s[0] == "piv.step"]
    phases = [s[0] for s in spans if s[0] in ("piv.step.augment", "piv.model", "piv.step.loss",
                                               "piv.step.backward", "piv.step.allreduce", "piv.step.optimizer")]
    assert phases == ["piv.step.augment", "piv.model", "piv.step.loss", "piv.step.backward", "piv.step.optimizer"]
    assert all(_inside(s, root) for s in spans)
    starts = {s[0]: s for s in spans}
    assert all(starts[a][3] <= starts[b][2] for a, b in zip(phases, phases[1:]))


def test_loader_spans_stage_and_wait_on_their_own_threads(tmp_path, capsys):
    batches = [(_frames(2, 8, 8, i), i) for i in range(3)]
    with profiling.trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("piv.test.consumer"):
            got = [(tuple(t.clone() for t in imgs), k) for imgs, k in PrefetchLoader(batches, "cpu")]
    assert [k for _, k in got] == [0, 1, 2]
    for (imgs, _), (want, _) in zip(got, batches):
        assert all(torch.equal(a, torch.from_numpy(b)) for a, b in zip(imgs, want))
    spans = _spans(prof)
    consumer = next(s[1] for s in spans if s[0] == "piv.test.consumer")
    stage = [s for s in spans if s[0] == "piv.loader.stage"]
    wait = [s for s in spans if s[0] == "piv.loader.wait"]
    assert len(stage) == 3 and len(wait) == 4  # the last wait takes the end of the stream
    assert {s[1] for s in wait} == {consumer}
    assert len({s[1] for s in stage}) == 1 and stage[0][1] != consumer
    assert "trace written" in capsys.readouterr().out
