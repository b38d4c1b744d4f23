"""The port's flow colours (``utils/flow_viz.py``, its own numpy copy) held to the JAX
package's: the colour wheel, ``compute_color`` and ``motion_to_color`` bit-equal,
``quiver_plot``'s returns equal and its PNG written."""

import numpy as np
import pytest

from piv_liteflownet_tpu.utils import flow_viz as jviz
from piv_liteflownet_tpu_torch.utils import flow_viz as pviz


def test_colorwheel_is_jax_s():
    np.testing.assert_array_equal(pviz.make_colorwheel(), jviz.make_colorwheel())
    assert pviz.make_colorwheel().shape == (55, 3)


@pytest.mark.parametrize("original_color", [False, True])
def test_compute_color_is_bit_equal_to_jax(original_color):
    rng = np.random.default_rng(0)
    fx, fy = rng.uniform(-1.2, 1.2, (2, 37, 41))  # inside and outside the unit disc
    got = pviz.compute_color(fx, fy, original_color)
    assert got.dtype == np.uint8 and got.shape == (37, 41, 3)
    np.testing.assert_array_equal(got, jviz.compute_color(fx, fy, original_color))


@pytest.mark.parametrize("case", ["single", "sequence", "maxmotion", "zero", "unknown"])
def test_motion_to_color_is_bit_equal_to_jax(case):
    rng = np.random.default_rng(1)
    flow = (3 * rng.standard_normal((2, 19, 23, 2))).astype(np.float32)
    kw = {}
    if case == "single":
        flow = flow[0]
    elif case == "maxmotion":
        kw = {"maxmotion": 2.5}
    elif case == "zero":
        flow = np.zeros((9, 11, 2), np.float32)
    elif case == "unknown":
        flow[0, 3:5, 4:9] = 2e9
    got = pviz.motion_to_color(flow, **kw)
    np.testing.assert_array_equal(got, jviz.motion_to_color(flow, **kw))
    assert got.shape == flow.shape[:-1] + (3,)
    if case == "unknown":
        assert (got[0, 3:5, 4:9] == 0).all()


def test_quiver_plot_returns_jax_s_and_writes_the_png(tmp_path):
    flow = np.random.default_rng(2).standard_normal((6, 8, 2)).astype(np.float32)
    for norm in (False, True):
        out = str(tmp_path / f"q{int(norm)}.png")
        got = pviz.quiver_plot(flow, filename=out, norm=norm)
        want = jviz.quiver_plot(flow, norm=norm)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(AssertionError, match="image format"):
        pviz.quiver_plot(flow, filename=str(tmp_path / "q.jpg"))
