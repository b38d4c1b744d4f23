"""The work counts of ``work.py`` against the program, on the CPU: the convs' operations against
torch's ``FlopCounterMode`` on the program's model, the ops' shapes against those the model
hands its ops, their bytes against their shapes, and the kernel groups against the program's
kernel names."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import trace, work

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {1: "piv-lfn-en-v1-f32", 2: "piv-lfn2-en-v2-bf16"}


def model_entry(version):
    return json.loads((ROOT / "h100_bench" / "configs" / f"{CONFIGS[version]}.json").read_text())["model"]


def port_model(version, conv_impl="cudnn"):
    from piv_liteflownet_tpu_torch.models.liteflownet import LiteFlowNet, ModelConfig

    m = model_entry(version)
    net = LiteFlowNet(ModelConfig(version=m["version"], starting_scale=m["starting_scale"],
                                  lowest_level=m["lowest_level"], rgb_mean=tuple(m["rgb_mean"]), conv_impl=conv_impl))
    net.init_parameters(torch.Generator().manual_seed(0))
    return net


def pair(b, size):
    g = torch.Generator().manual_seed(1)
    return torch.rand((b, 3, size, size), generator=g), torch.rand((b, 3, size, size), generator=g)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("size", [64, 128])
def test_conv_flops_equal_flop_counter(version, size):
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS

    net = port_model(version)
    x1, x2 = pair(2, size)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(x1, x2, PLAIN_OPS)
    assert fc.get_total_flops() == work.conv_flops(model_entry(version), 2, size, size)
    with FlopCounterMode(display=False) as fc:
        outs = net(x1, x2, PLAIN_OPS, train=True)
        sum(f.sum() for level in outs for f in level).backward()
    # FlopCounterMode counts a transposed conv's weight gradient without its groups: for the
    # depthwise deconvs C times the work (C outputs of C inputs each, not of one)
    over = sum((c.cin - 1) * c.flops for c in work.convs(model_entry(version), 2, size, size) if c.transposed_groups)
    assert fc.get_total_flops() - over == work.conv_flops(model_entry(version), 2, size, size, train=True)


def recording_ops(calls):
    from piv_liteflownet_tpu_torch.models.liteflownet import PLAIN_OPS, Ops

    def corr49(f1, f2):
        out = PLAIN_OPS.corr49(f1, f2)
        calls.append(("corr49", (tuple(f1.shape), tuple(f2.shape)), (tuple(out.shape),)))
        return out

    def backwarp(img, flow, stride=1):
        out = PLAIN_OPS.backwarp(img, flow, stride)
        calls.append(("backwarp", (tuple(img.shape), tuple(flow.shape)), (tuple(out.shape),)))
        return out

    def rgb_warp_norm(a, b, flow):
        out = PLAIN_OPS.rgb_warp_norm(a, b, flow)
        calls.append(("rgb_warp_norm", (tuple(a.shape), tuple(b.shape), tuple(flow.shape)), (tuple(out.shape),)))
        return out

    def conv_chain(parts, ws, bs, last_linear=True):
        out = PLAIN_OPS.conv_chain(parts, ws, bs, last_linear)
        calls.append(("conv_chain", tuple(tuple(p.shape) for p in parts), (tuple(out.shape),)))
        return out

    return Ops(corr49, backwarp, rgb_warp_norm, conv_chain)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("chain", [False, True])
def test_port_ops_follow_the_models_calls(version, size, chain):
    """The ops and shapes that the model hands its custom ops, in order; in training each warp
    and each cost volume has its gradient once."""
    calls = []
    net = port_model(version, "chain" if chain else "cudnn")
    x1, x2 = pair(2, size)
    with torch.no_grad():
        net(x1, x2, recording_ops(calls))
    ops = work.port_ops(model_entry(version), 2, size, size, chain=chain)
    assert [(o.name, o.inputs, o.outputs) for o in ops] == calls
    train = work.port_ops(model_entry(version), 2, size, size, chain=chain, train=True)
    counts = work.op_counts(train)
    assert "conv_chain" not in counts
    assert counts["backwarp_bwd"] == counts["backwarp"] and counts["corr49_bwd"] == counts["corr49"]


def test_op_bytes_follow_from_shapes():
    f = (2, 64, 32, 48)
    corr = work.Op("corr49", (f, f), ((2, 49, 32, 48),), 2 * 49 * 2 * 64 * 32 * 48)
    n = 2 * 64 * 32 * 48
    assert corr.bytes(2) == 2 * (2 * n + 2 * 49 * 32 * 48)
    assert corr.bytes(4) == 2 * corr.bytes(2)
    assert corr.bound_s(4, 165e12) == max(corr.bytes(4) / work.HBM_BYTES_S, corr.flops / 165e12)
    for op in work.port_ops(model_entry(2), 8, 256, 256, chain=True) + work.port_ops(model_entry(1), 8, 256, 256, train=True):
        elems = sum(work._numel(s) for s in op.inputs + op.outputs) + op.weights
        assert op.bytes(2) == 2 * elems > 0
        assert op.flops > 0
    chains = [o for o in work.port_ops(model_entry(1), 1, 64, 64, chain=True) if o.name == "conv_chain"]
    # v1 at 64^2: levels 1 and 2 (64^2 and 32^2) take the chain, three stacks each
    assert len(chains) == 6


def test_every_kernel_of_the_program_falls_in_exactly_one_group():
    from piv_liteflownet_tpu_torch.breakdown import GROUPS

    groups = trace.kernel_groups()
    port = [name for group, names in GROUPS if group in {g for g in groups} for name in names]
    assert len(port) >= 12
    for name in port:
        for demangled in (name, f"void pivk::{name}<64, 8>(float const*, int)", f"{name}(__nv_bfloat16*)"):
            assert len(trace.groups_of(demangled, groups)) == 1, demangled
    ops = {op for spec in groups.values() for op in spec["ops"]}
    assert ops == {"corr49", "backwarp", "rgb_warp_norm", "conv_chain", "corr49_bwd", "backwarp_bwd"}


def test_trace_reader_on_synthetic_events():
    device = [("void corr49_kernel<4>(float*)", 1.0, 1.5), ("sm90_xmma_fprop_implicit", 1.4, 2.0),
              ("nchwToNhwcKernel", 2.5, 2.6), ("elementwise_kernel", 3.0, 3.2)]
    spans = [("h100_bench.window", 0.9, 4.0), ("h100_bench.loader_wait", 2.0, 2.5), ("h100_bench.step", 3.2, 4.0)]
    t = trace.Trace(device, spans, (0.9, 4.0))
    assert t.window_s == pytest.approx(3.1)
    assert t.busy_s() == pytest.approx(0.5 + 0.5 + 0.1 + 0.2)
    assert t.port_kernel_s() == {"corr49": pytest.approx(0.5)}
    assert t.conv_s() == pytest.approx(0.7)
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["step", pytest.approx(0.8)]
    assert b["idle_gaps"][1][0] == "loader_wait"
    assert b["device_ops"][0][0].startswith("sm90_xmma")
