"""Flow post-processing of the port (``postpro.calc_vorticity``, ``de_vort``) held to the JAX
package's on ``[H,W,2]`` and ``[B,H,W,2]`` flows of odd sizes, with ``calib`` other than 1:
every output within atol 1e-6, in the flow's dtype and shape."""

import numpy as np
import pytest
import torch

from piv_liteflownet_tpu_torch import postpro


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once; these tests use one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["calc_vorticity", "de_vort"])
@pytest.mark.parametrize("shape,calib", [((13, 17, 2), 2.5), ((3, 11, 9, 2), 0.75), ((1, 5, 3, 2), 1.0)])
def test_postpro_matches_jax(name, shape, calib):
    import jax.numpy as jnp

    from piv_liteflownet_tpu import postpro as jpostpro

    flow = (3.0 * np.random.default_rng(len(shape) + shape[0]).standard_normal(shape)).astype(np.float32)
    want = getattr(jpostpro, name)(jnp.asarray(flow), calib=calib)
    got = getattr(postpro, name)(torch.from_numpy(flow), calib=calib)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape[:-1]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_postpro_keeps_the_dtype_and_rejects_other_shapes():
    flow = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 7, 6, 2)))
    vort, uy, vx = postpro.de_vort(flow, calib=2.0)
    assert vort.dtype == torch.float64 and vort.shape == (2, 7, 6)
    torch.testing.assert_close(vort, vx - uy, rtol=0, atol=0)
    single = postpro.calc_vorticity(flow[1])
    for a, b in zip(single, postpro.calc_vorticity(flow)):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)
    for bad in (flow[..., :1], flow[0, 0], flow.long()):
        with pytest.raises(ValueError):
            postpro.calc_vorticity(bad)
