"""Whole runs of each cell on the CPU at a tiny size, past the harness's look for a card, with
the timed path broken underneath: each fault the cell can have makes ``correct`` false, and
the sound program keeps it true. The limits are the cells' own."""

import pytest
import torch

from conftest import RUN_SMALL, TRAIN_SMALL
from h100_bench import harness

RUN, TRAIN = "lfn2-bf16-run-1024-b8", "lfn1-f32-train-256-b8"


def broken_estimate(real, fault):
    first = []

    def estimate(model, im1, im2, **kw):
        flow = real(model, im1, im2, **kw)
        if fault == "state_unchanged":  # every call returns the first call's flows
            if not first:
                first.append(flow.clone())
            return first[0].clone()
        if fault == "half_batch":  # the second half of the batch left out: the first half's flows
            half = flow.shape[0] // 2
            flow = flow.clone()
            flow[half:] = flow[:half]
            return flow
        if fault == "answer_altered":  # one pair's answer altered where it is made: another pair's flow
            flow = flow.clone()
            flow[0] = flow[1]
            return flow
        return flow

    return estimate


def broken_step(real_make, fault):
    def make(cfg, loss_obj, opt, **kw):
        real = real_make(cfg, loss_obj, opt, **kw)

        def step(state, im1, im2, target, rng=None):
            if fault == "half_batch":  # half of the batch left out, the mean over the rest
                h = im1.shape[0] // 2
                return real(state, im1[:h], im2[:h], target[:h], rng)
            params = [p.detach().clone() for p in state.model.parameters()]
            state, metrics = real(state, im1, im2, target, rng)
            with torch.no_grad():  # the state returned unchanged
                for p, q in zip(state.model.parameters(), params):
                    p.copy_(q)
            opt.state.clear()
            return state, metrics

        step.compute_dtype = real.compute_dtype
        return step

    return make


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch", "answer_altered"])
def test_run_cell_faults(fault, monkeypatch, few_threads):
    from piv_liteflownet_tpu_torch import inference

    if fault is not None:
        monkeypatch.setattr(inference, "estimate", broken_estimate(inference.estimate, fault))
    out = harness.run_cell(RUN, 2 ** 31 + 11, 1.0, False, device="cpu", overrides=RUN_SMALL)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_train_cell_faults(fault, monkeypatch, few_threads):
    from piv_liteflownet_tpu_torch.parallel import train_step

    if fault is not None:
        monkeypatch.setattr(train_step, "make_train_step", broken_step(train_step.make_train_step, fault))
    out = harness.run_cell(TRAIN, 2 ** 31 + 12, 0.5, False, device="cpu", overrides=TRAIN_SMALL)
    assert out["correct"] is (fault is None), out["checks"]
