"""``spans.py``: the attribution of runtime calls, device events and idle gaps to the program's
spans on synthetic events (the thread fallback, correlation, a pageable copy, gaps with and
without a program span), its three readings, that it leaves every reading of ``Trace`` as it
was, and CPU runs of a cell's traced window; on the card, a short run of each cell."""

import json
from pathlib import Path

import pytest

from h100_bench import spans, trace

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
MAIN, LOADER, AUTOGRAD = 1, 3, 7

# the harness's spans and window, seconds
HARNESS = [("h100_bench.window", 0.0, 20.0), ("h100_bench.loader_wait", 0.0, 1.0),
           ("h100_bench.step", 1.0, 12.0), ("h100_bench.readback", 12.0, 13.0)]
PROGRAM = [("piv.loader.wait", MAIN, 0.1, 0.9),
           ("piv.step", MAIN, 1.0, 11.0), ("piv.step.augment", MAIN, 1.1, 1.9), ("piv.model", MAIN, 2.0, 5.0),
           ("piv.L6.NetE-M", MAIN, 2.5, 3.5), ("piv.step.loss", MAIN, 5.0, 5.5),
           ("piv.step.backward", MAIN, 6.0, 9.0), ("piv.step.optimizer", MAIN, 9.5, 10.5),
           ("piv.loader.stage", LOADER, 0.2, 0.6), ("piv.loader.stage", LOADER, 6.0, 6.4)]
CALLS = [("cudaMemcpyAsync", LOADER, 0.3, 0.31, 1),         # the loader's copy, in its stage
         ("cudaLaunchKernel", MAIN, 1.5, 1.51, 2),          # augment
         ("cudaLaunchKernel", MAIN, 3.0, 3.01, 3),          # NetE-M's conv
         ("cudaLaunchKernel", MAIN, 3.1, 3.11, 4),          # NetE-M's elementwise add
         ("cudaLaunchKernel", MAIN, 4.5, 4.51, 5),          # the model's own
         ("cudaLaunchKernel", AUTOGRAD, 7.0, 7.01, 6),      # the backward, on autograd's thread
         ("cudaMemcpyAsync", MAIN, 5.2, 5.4, 7),            # a loss read into pageable memory
         ("cudaStreamSynchronize", MAIN, 5.4, 5.45, 8),
         ("cudaMemcpyAsync", LOADER, 6.2, 6.25, 9),         # a pinned copy, the loader's
         ("cudaLaunchKernel", MAIN, 10.0, 10.01, 10),       # Adam
         ("cudaLaunchKernel", MAIN, 10.8, 10.81, 11),       # the step's own
         ("cudaStreamSynchronize", MAIN, 12.0, 12.5, 12),   # the harness's readback
         ("cudaLaunchKernel", MAIN, 12.05, 12.06, 15),      # the harness's own kernel
         ("cudaEventRecord", LOADER, 0.5, 0.51, 13),        # no device work
         ("cudaLaunchKernel", LOADER, 0.8, 0.81, 14)]       # the loader thread, outside its spans
DEVICE = [("Memcpy HtoD (Pinned -> Device)", 0.55, 0.9, 1),
          ("transform_kernel", 1.6, 1.8, 2),
          ("sm90_xmma_fprop_implicit_gemm", 3.05, 3.45, 3),
          ("void at::native::elementwise_kernel<128, 4>", 3.45, 3.6, 4),
          ("void at::native::vectorized_elementwise_kernel<4>", 4.6, 4.85, 5),
          ("backwarp_bwd_kernel", 7.1, 7.5, 6),
          ("Memcpy DtoH (Device -> Pageable)", 5.3, 5.31, 7),
          ("Memcpy HtoD (Pinned -> Device)", 6.3, 6.6, 9),
          ("multi_tensor_apply_kernel", 10.1, 10.6, 10),
          ("void at::native::vectorized_elementwise_kernel<2>", 10.9, 11.0, 11),
          ("void at::native::elementwise_kernel<128, 2>", 12.1, 12.2, 15),
          ("reduce_kernel", 0.85, 0.86, 14),
          ("orphan_kernel", 15.0, 15.5, 99)]
GROUPS = {"backwarp_bwd": {"ops": [], "kernels": ["backwarp_bwd_kernel"]}}


def build():
    tr = trace.Trace([(n, s, e) for n, s, e, _ in DEVICE], HARNESS, (0.0, 20.0), groups=GROUPS)
    return tr, spans.Attribution(tr, spans.Events(spans=PROGRAM, calls=CALLS, device=DEVICE))


def test_runtime_calls_take_their_threads_span_else_the_entry_threads():
    _, att = build()
    held = {c[4]: h for c, h in zip(att.calls, att.call_span)}
    assert att.entry_thread == MAIN
    assert held[1] == ("piv.loader.stage", "piv.loader.stage")
    assert held[3] == ("piv.L6.NetE-M", "piv.step")
    assert held[5] == ("piv.model", "piv.step")
    assert held[6] == ("piv.step.backward", "piv.step")  # autograd's thread opens no span
    assert held[11] == ("piv.step", "piv.step")
    assert held[12] is None  # the harness's readback, outside the program
    assert held[14] is None  # the loader's thread has spans: outside them is outside the program


def test_device_events_take_their_calls_span_by_correlation():
    _, att = build()
    by = att.device_by_span()
    assert by["piv.L6.NetE-M"] == pytest.approx({"conv": 0.4, "elementwise": 0.15, "total": 0.55})
    assert by["piv.step.backward"] == pytest.approx({"port": 0.4, "total": 0.4})
    assert by["piv.loader.stage"] == pytest.approx({"copy": 0.65, "total": 0.65})
    assert by["piv.step.loss"] == pytest.approx({"copy": 0.01, "total": 0.01})
    # the harness's kernel, the loader thread's outside its spans, one whose call is not traced
    assert att.unattributed_busy_s() == pytest.approx(0.1 + 0.01 + 0.5)
    assert by[None]["total"] == pytest.approx(0.61)
    assert att.entry_self_share() == pytest.approx(0.1 / (0.2 + 0.55 + 0.25 + 0.4 + 0.01 + 0.5 + 0.1))


def test_a_pageable_copy_and_the_syncs_are_host_syncs_in_the_entry_subtree_only():
    _, att = build()
    blocking = {c[4] for c in att.calls if att.blocking(c)}
    assert blocking == {7, 8, 12}  # not the pinned copies
    assert att.host_sync_s() == pytest.approx(0.2 + 0.05)  # the readback's sync is the harness's


def test_idle_gaps_are_named_by_program_span_else_by_the_harness():
    tr, att = build()
    out = att.breakdown()
    gaps = out["idle_gaps_by_span"]
    assert [g[1] for g in gaps] == [g[1] for g in tr.breakdown()["idle_gaps"]]
    outside = "outside the harness's spans"
    want = [(outside, 4.5), (outside, 2.8), ("piv.step.backward", 2.6), ("piv.model", 1.25),
            ("step", 1.1), ("piv.model", 1.0), ("piv.step", 0.99), ("piv.step.augment", 0.7),
            ("piv.loader.wait", 0.55), ("piv.step.backward", 0.5)]
    assert [g[0] for g in gaps] == [n for n, _ in want]
    assert [g[1] for g in gaps] == pytest.approx([s for _, s in want])
    assert out["device_by_span"][0] == ["piv.loader.stage", pytest.approx(0.65)]
    assert out["unattributed_busy_s"] == pytest.approx(0.61)


def test_the_three_readings():
    _, att = build()
    stats = {"calls": 2, "items": 16}
    # launches: the step subtree's calls that a device event carries (augment, NetE-M's two, the
    # model's own, the backward's, the loss's copy, Adam's, the step's own)
    assert att.launches() == 8
    assert spans.launches_per_call(att, stats) == 4.0
    assert spans.host_sync_ms_per_call(att, stats) == pytest.approx(1e3 * 0.25 / 2)
    # elementwise: NetE-M's add and the model's own, not augment's, Adam's or the step's own
    assert spans.elementwise_ms_per_item(att, stats) == pytest.approx(1e3 * (0.15 + 0.25) / 16)


def test_readings_are_none_without_runtime_calls_or_program_spans():
    tr = trace.Trace([(n, s, e) for n, s, e, _ in DEVICE], HARNESS, (0.0, 20.0), groups=GROUPS)
    stats = {"calls": 2, "items": 16}
    for events in (spans.Events(spans=PROGRAM), spans.Events(calls=CALLS, device=DEVICE), spans.Events()):
        att = spans.Attribution(tr, events)
        assert all(fn(att, stats) is None for fn in spans.READINGS.values())
        assert att.breakdown()["idle_gaps_by_span"]
    assert spans.Attribution(tr, spans.Events(spans=PROGRAM)).breakdown()["unattributed_busy_s"] == 0.0


def test_attribution_leaves_the_traces_readings_as_they_were():
    def readings(tr):
        return (tr.busy_s(), tr.conv_s(), tr.port_kernel_s(), tr.idle_gaps(), tr.breakdown(),
                [tr.host_at(t / 4) for t in range(80)], tr.spans, tr.device, tr.window_s)

    device = [(n, s, e) for n, s, e, _ in DEVICE]
    before = readings(trace.Trace(device, HARNESS, (0.0, 20.0), groups=GROUPS))
    tr, att = build()
    att.breakdown(), att.device_by_span(), att.launches(), att.host_sync_s(), att.elementwise_s()
    assert readings(tr) == before


def test_device_classes():
    groups = trace.kernel_groups()
    want = {"Memset (Device)": "memset", "Memcpy DtoH (Device -> Pinned)": "copy",
            "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>": "transpose",
            "sm90_xmma_fprop_implicit_gemm_bf16bf16": "conv",
            "void (anonymous namespace)::conv_chain_bf16_kernel<3>(Params)": "port",
            "void at::native::elementwise_kernel<128, 4>(int, Loop)": "elementwise",
            "void at::native::im2col_kernel<c10::BFloat16>(long, c10::BFloat16 const*)": "elementwise",
            # a 1x1 conv's cuBLAS GEMM and cuDNN's FFT conv's product: conv work, not elementwise
            "nvjet_tst_448x64_64x2_2x1_v_bz_coopB_NNN": "conv",
            "void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*, float2*, int)": "conv",
            # a library kernel that nothing names stays out of ``elementwise``
            "void internal::region_transform_ABC_val<int, 32, 32, false>(Params)": "other",
            "multi_tensor_apply_kernel": "other"}
    for name, cls in want.items():
        assert spans.device_class(name, groups) == cls, name


def test_runtime_calls_are_told_apart_by_name():
    calls = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaStreamSynchronize", "cuMemFree_v2")
    others = ("aten::copy_", "piv.step", "h100_bench.step", "cudnn_convolution", "Memcpy HtoD")
    assert all(spans.RUNTIME_CALL.match(n) for n in calls)
    assert not any(spans.RUNTIME_CALL.match(n) for n in others)


def test_the_harness_keeps_program_spans_out_of_its_own(few_threads):
    """CPU runs through ``spans.traced_window`` and ``spans.report``: the program's spans are
    there a call, on the caller's and the producer's threads, the harness's ``Trace`` holds none
    of them, and with no CUDA event every reading is None."""
    from conftest import RUN_SMALL, TRAIN_SMALL

    tr, events, stats, _ = spans.traced_window(CELLS[0], 2 ** 31 + 21, 0.3, device="cpu", overrides=RUN_SMALL)
    count = {n: sum(1 for s in events.spans if s[0] == n) / stats["calls"] for n, *_ in events.spans}
    assert count["piv.estimate"] == 1 and count["piv.NetC"] == 2 and count["piv.loader.stage"] >= 1
    assert len({tid for _, tid, _, _ in events.spans}) == 2
    assert not any(n.startswith("piv.") for n, *_ in tr.spans)
    att = spans.Attribution(tr, events)
    assert all(fn(att, stats) is None for fn in spans.READINGS.values())
    assert not any(n.startswith("piv.") for n, _ in tr.breakdown()["idle_gaps"])
    train = spans.report(CELLS[1], 2 ** 31 + 22, 0.3, device="cpu", overrides=TRAIN_SMALL)
    assert train["metrics"] == {"launches.train": None, "host_sync_ms.train": None, "elementwise_ms.train": None}
    assert train["calls"] >= 1 and train["entry_self_share"] is None


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_window_on_the_card_reads_every_new_metric(workload, cuda_device):
    out = spans.report(workload, 2 ** 31 + 23, 1.0)
    assert all(v is not None and v >= 0 for v in out["metrics"].values()), out["metrics"]
    assert out["metrics"][next(k for k in out["metrics"] if k.startswith("launches"))] > 10
    assert out["span_breakdown"]["unattributed_busy_s"] <= 0.05 * out["busy_s"], out["span_breakdown"]
    assert out["entry_self_share"] < 0.02, out["entry_self_share"]
