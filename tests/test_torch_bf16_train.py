"""bfloat16 training in the PyTorch port against the JAX package's bf16 train step.

The JAX package trains in mixed precision with ``make_train_step(...,
compute_dtype=jnp.bfloat16)`` (``piv_liteflownet_tpu/parallel/train_step.py:56-74``):
float32 master params cast to bf16 at the forward boundary, bf16 forward and
backward, outputs cast back to float32 before the loss. The port's
``make_train_step(..., compute_dtype=torch.bfloat16)`` does the same, with the
kernels' bf16 forms on the card (``pivk_backwarp_bwd_bf16``,
``pivk_corr49_bwd_bf16`` among them) and autograd through the plain ops in bf16
on the CPU. Here, on the CPU, from the same seeded numpy inputs (cast to bf16
on both sides) and the same JAX params (``from_jax_params``):

- each bf16 backward op (``backwarp`` at strides 1 and 2, image and flow, one
  case steep enough for the kernel's out-of-window path; ``corr49``, both maps)
  against ``jax.vjp`` of JAX's ``backwarp`` and ``correlation_xla`` in bf16.
  Both are held to the float32 truth, the float32 VJP on the bf16 inputs
  upcast: the port's max abs error may be at most twice JAX's plus 2^-7 of
  max|truth| (JAX's bf16 rule, ``tests/test_pallas_ondevice.py:97-110``);
- one bf16 train step of piv v1 at 64x96 b2 against JAX's, whose gradients a
  pass-through optax transform keeps in its state. Truth: JAX's float32 step
  (Precision.HIGHEST). The loss: ``|loss_port - loss_f32| <= 2 |loss_jax_bf16 -
  loss_f32| + 1e-3 |loss_f32|``. The gradients, as relative L2 errors against
  the truth (``training/precision.py:grad_relation``): over all parameters as
  one vector, in the median over the parameters, and at the worst parameter,
  each at most twice JAX's (and the worst at most 0.02 where JAX's worst is
  smaller). Parameter by parameter, the relation "error within max(twice the
  other's, 0.02)" is taken both ways: the port's gradients may fail it against
  JAX's on no more parameters, and by no larger a factor, than JAX's fail it
  against the port's. One way only it is decided by rounding order, not by
  accuracy: at three seeds it fails on 11, 24 and 14 of the 252 parameters
  (other stacks at each seed), JAX's against the port's on 36, 34 and 32, and
  the port against itself with one conv of each S and R stack summed per
  input part as JAX sums it, on 15, 2 and 8 (``tests/bf16_grad_seeds.py``);
- the contracts: float32 params, gradients and Adam state after a bf16 step;
  no float32 module output inside the bf16 forward; ``compute_dtype=float32``
  is exactly the float32 step; float16 raises; ``Train`` with a bf16 step
  checkpoints float32 params and resumes to the uninterrupted state;
- the kernel path without a card: a bf16 step of v1 and v2 through faked
  launches reaches only the ``_bf16`` entry points (v1: 6/11/6 forward, 11
  ``backwarp_bwd`` and 6 ``corr49_bwd``), the launches pass the float32 forms'
  arguments (the warp gradient's with its slow-path counter and the int32 boxes of
  its owner rectangles), and the cost-volume
  backward's bf16 tile rule and layout, read back from the source and replayed.

The ``gpu`` tests hold each bf16 backward kernel on the card to the float32
plain backward on the bf16 inputs upcast, rounded once to bf16, within one bf16
ulp plus the float32 kernels' tolerance, and a bf16 train step through the
kernels to one through the plain ops, under the step relation above.
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from piv_liteflownet_tpu_torch import kernels, piv_liteflownet
from piv_liteflownet_tpu_torch.kernels import build
from piv_liteflownet_tpu_torch.models import factory
from piv_liteflownet_tpu_torch.models.convert import from_jax_params
from piv_liteflownet_tpu_torch.models.liteflownet import KERNEL_OPS, PLAIN_OPS
from piv_liteflownet_tpu_torch.ops import correlation, rgb_warp, warp
from piv_liteflownet_tpu_torch.parallel.train_step import TrainState, make_eval_step, make_train_step
from piv_liteflownet_tpu_torch.trainer import Train, TrainArgs, resume
from piv_liteflownet_tpu_torch.training import loss as tloss
from piv_liteflownet_tpu_torch.training.optim import make_optimizer
from piv_liteflownet_tpu_torch.training.precision import GRAD_FLOOR, grad_relation, rel_err
from piv_liteflownet_tpu_torch.utils.checkpoint import restore_checkpoint
from piv_liteflownet_tpu_torch.utils.metrics import Experiment

BF16 = torch.bfloat16
EPS = float(torch.finfo(BF16).eps)  # 2^-7
CSRC = Path(correlation.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes run at once; one torch thread each (as tests/test_torch_train.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, held in float32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16).float().numpy()


def _nchw(a: np.ndarray, dtype=BF16) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _batch(b, h, w, seed):
    """A pair and a raw target flow of a few pixels, NHWC (as tests/test_torch_train.py)."""
    rng = np.random.default_rng(seed)
    img1 = rng.random((b, h, w, 3), dtype=np.float32)
    img2 = np.clip(img1 + 0.05 * rng.standard_normal((b, h, w, 3), dtype=np.float32), 0, 1)
    target = (3.0 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    return img1, img2, target


def _hold_op(got: np.ndarray, jax_bf16: np.ndarray, truth: np.ndarray, what: str) -> None:
    """JAX's bf16 rule: the port's max abs error at most twice JAX's plus 2^-7 of max|truth|."""
    err, jerr = float(np.abs(got - truth).max()), float(np.abs(jax_bf16 - truth).max())
    tol = 2 * jerr + EPS * float(np.abs(truth).max())
    assert err <= tol, f"{what}: port bf16 error {err:.3e}, JAX bf16 {jerr:.3e}, bound {tol:.3e}"


# -- each bf16 backward op against JAX's bf16 VJP ------------------------------------------

@pytest.mark.parametrize("shape,stride", [((2, 21, 31, 8), 1), ((1, 16, 24, 32), 2), ((1, 9, 13, 64), 1)])
def test_backwarp_plain_bf16_rounds_once_as_jax(shape, stride):
    """The plain bf16 warp sums its four taps in float32 and rounds once, as JAX's ``einsum`` over
    the taps does: the two agree bit for bit. (It rounded after every tap before, and differed
    from JAX in 23-35 % of the values at these shapes, hidden by a tolerance of one bf16
    epsilon.)"""
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.warp import backwarp as jbackwarp

    b, h, w, _ = shape
    ho, wo = warp.out_hw(h, w, stride)
    rng = np.random.default_rng(w + stride)
    img = rng.standard_normal(shape).astype(np.float32)
    flow = rng.uniform(-6, 6, (b, ho, wo, 2)).astype(np.float32)
    want = np.asarray(jbackwarp(jnp.asarray(img, jnp.bfloat16), jnp.asarray(flow, jnp.bfloat16), stride)
                      .astype(jnp.float32))
    got = warp.backwarp_plain(_nchw(img), _nchw(flow), stride)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("shape,stride,mag", [
    ((2, 21, 31, 5), 1, 4.0), ((1, 16, 24, 32), 1, 8.0), ((2, 21, 31, 7), 2, 4.0),
    ((1, 40, 96, 16), 1, 30.0),  # steep: tiles out of the kernel's shared-memory window
])
def test_backwarp_bf16_vjp_matches_jax(shape, stride, mag):
    import jax
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.warp import backwarp as jbackwarp

    b, h, w, c = shape
    ho, wo = warp.out_hw(h, w, stride)
    rng = np.random.default_rng(h + w + stride)
    img = _bf16_round(rng.standard_normal(shape).astype(np.float32))
    flow = _bf16_round(rng.uniform(-mag, mag, (b, ho, wo, 2)).astype(np.float32))
    gout = _bf16_round(rng.standard_normal((b, ho, wo, c)).astype(np.float32))

    @jax.jit
    def vjp(i, f, g):
        return jax.vjp(lambda i, f: jbackwarp(i, f, stride), i, f)[1](g)

    def jax_vjp(dtype):
        return [np.asarray(x.astype(jnp.float32)) for x in vjp(*(jnp.asarray(a, dtype) for a in (img, flow, gout)))]

    truth, jax_bf16 = jax_vjp(jnp.float32), jax_vjp(jnp.bfloat16)
    ti, tf = _nchw(img).requires_grad_(), _nchw(flow).requires_grad_()
    out = warp.backwarp(ti, tf, stride)
    out.backward(_nchw(gout))
    assert out.dtype == ti.grad.dtype == tf.grad.dtype == BF16
    _hold_op(_nhwc(ti.grad), jax_bf16[0], truth[0], f"g_img {shape} stride {stride}")
    _hold_op(_nhwc(tf.grad), jax_bf16[1], truth[1], f"g_flow {shape} stride {stride}")
    if mag == 30.0:  # the kernel would take its global-atomic path for some tiles here
        assert warp.out_of_window_tiles(tf.detach().float(), h, w, stride) > 0


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(2, 20, 30, 16), (1, 9, 13, 32)])
def test_corr49_bf16_vjp_matches_correlation_xla(shape, stride):
    import jax
    import jax.numpy as jnp

    from piv_liteflownet_tpu.ops.correlation import correlation_xla

    b, h, w, c = shape
    rng = np.random.default_rng(sum(shape) + 10 * stride)
    f1, f2 = (_bf16_round(rng.standard_normal(shape).astype(np.float32)) for _ in range(2))
    hs, ws = -(-h // stride), -(-w // stride)
    g = _bf16_round(rng.standard_normal((b, hs, ws, 49)).astype(np.float32))

    @jax.jit
    def vjp(a, bb, gg):
        return jax.vjp(lambda a, bb: correlation_xla(a, bb, stride), a, bb)[1](gg)

    def jax_vjp(dtype):
        # the cost volume reads the even phase only: its gradient lives there
        return [np.asarray(x.astype(jnp.float32))[:, ::stride, ::stride]
                for x in vjp(*(jnp.asarray(a, dtype) for a in (f1, f2, g)))]

    truth, jax_bf16 = jax_vjp(jnp.float32), jax_vjp(jnp.bfloat16)
    t1, t2 = (_nchw(a[:, ::stride, ::stride]).requires_grad_() for a in (f1, f2))
    correlation.corr49(t1, t2).backward(_nchw(g))
    assert t1.grad.dtype == t2.grad.dtype == BF16
    _hold_op(_nhwc(t1.grad), jax_bf16[0], truth[0], f"g_f1 {shape} stride {stride}")
    _hold_op(_nhwc(t2.grad), jax_bf16[1], truth[1], f"g_f2 {shape} stride {stride}")


# -- the bf16 train step against JAX's -------------------------------------------------------

def per_parameter(got: dict, ref: dict, truth: dict) -> dict:
    """Each parameter's error in ``got`` over its bound from ``ref``, ``max(2 x ref's error,
    GRAD_FLOOR)``: a parameter meets the relation where this is at most 1."""
    return {n: rel_err(got[n], truth[n]) / max(2 * rel_err(ref[n], truth[n]), GRAD_FLOOR) for n in truth}


def _capture():
    """A pass-through optax transform whose state is the last gradient: the params stay, and the
    step's gradients come out exactly (no params - updated difference)."""
    import jax
    import jax.numpy as jnp
    import optax

    zeros = lambda tree: jax.tree.map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, state, params=None: (zeros(g), g))


def bf16_grads(model_seed: int, batch_seed: int, h: int = 64, w: int = 96) -> dict:
    """JAX's float32 and bf16 piv v1 steps and the port's bf16 step (plain ops) at ``h`` x ``w``
    b2: name -> (loss, gradients in the port's parameter names and layouts), and the params."""
    import jax
    import jax.numpy as jnp

    from piv_liteflownet_tpu.models import factory as jfactory
    from piv_liteflownet_tpu.parallel.train_step import TrainState as JaxState
    from piv_liteflownet_tpu.parallel.train_step import make_train_step as jax_make_train_step
    from piv_liteflownet_tpu.training import loss as jloss

    cfg = factory.config("piv", 1)
    jmodel = jfactory.piv_liteflownet(version=1, seed=model_seed)
    params = {k: np.asarray(v) for k, v in jmodel.params.items()}
    batch = _batch(2, h, w, seed=batch_seed)
    out = {"params": from_jax_params(cfg, params), "batch": batch}
    for name, dtype in (("f32", None), ("jax_bf16", jnp.bfloat16)):
        tx = _capture()
        step = jax_make_train_step(jmodel.cfg, jloss.piv_loss(), tx,
                                   precision=jax.lax.Precision.HIGHEST if dtype is None else None,
                                   compute_dtype=dtype)
        p = {k: jnp.asarray(v) for k, v in params.items()}  # the step donates its state
        state, metrics = step(JaxState(p, tx.init(p), jnp.zeros((), jnp.int32)), *batch, jax.random.PRNGKey(0))
        out[name] = (float(metrics["loss"]),
                     from_jax_params(cfg, {k: np.asarray(v, np.float32) for k, v in state.opt_state.items()}))
    out["port_bf16"] = port_bf16_step(out["params"], batch)
    return out


def port_bf16_step(params: dict, batch) -> tuple:
    """The port's bf16 piv v1 step (plain ops) from ``params``: (loss, gradients)."""
    cfg = factory.config("piv", 1)
    model = piv_liteflownet(params, version=1, device="cpu")
    opt = make_optimizer(model, cfg.lowest_level)
    step = make_train_step(cfg, tloss.piv_loss(), opt, ops=PLAIN_OPS, compute_dtype=BF16)
    _, metrics = step(TrainState(model, opt), *batch)
    return float(metrics["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def bf16_steps():
    return bf16_grads(model_seed=3, batch_seed=0)


def test_bf16_step_loss_matches_jax(bf16_steps, request):
    (loss_f32, _), (loss_jax, _), (loss_port, _) = (bf16_steps[k] for k in ("f32", "jax_bf16", "port_bf16"))
    for name, value in (("loss_f32", loss_f32), ("loss_jax_bf16", loss_jax), ("loss_port_bf16", loss_port)):
        request.node.user_properties.append((name, value))
    assert np.isfinite(loss_port)
    bound = 2 * abs(loss_jax - loss_f32) + 1e-3 * abs(loss_f32)
    assert abs(loss_port - loss_f32) <= bound, (loss_port, loss_jax, loss_f32)


@pytest.mark.parametrize("part", ["whole", "median", "worst"])
def test_bf16_step_grads_match_jax(bf16_steps, part, request):
    """The step relation, each part recorded in the JUnit XML (``--junitxml``)."""
    truth, jax_grads, port_grads = (bf16_steps[k][1] for k in ("f32", "jax_bf16", "port_bf16"))
    assert list(port_grads) == list(truth)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in port_grads.values())
    err, jax_err, bound = grad_relation(port_grads, jax_grads, truth)[part]
    for name, value in (("port_bf16", err), ("jax_bf16", jax_err), ("bound", bound)):
        request.node.user_properties.append((name, value))
    assert err <= bound, f"{part}: port bf16 {err:.4e}, JAX bf16 {jax_err:.4e}, bound {bound:.4e}"


@pytest.mark.parametrize("part", ["count", "factor"])
def test_bf16_step_grads_per_parameter_no_further_from_jax(bf16_steps, part, request):
    """Parameter by parameter, the port's gradients fail "error within max(2 x JAX's, 0.02)" on no
    more parameters (``count``), and by no larger a factor (``factor``), than JAX's fail the same
    relation against the port's. The parameters beyond are recorded in the JUnit XML."""
    truth, jax_grads, port_grads = (bf16_steps[k][1] for k in ("f32", "jax_bf16", "port_bf16"))
    port_over, jax_over = per_parameter(port_grads, jax_grads, truth), per_parameter(jax_grads, port_grads, truth)
    beyond = [n for n, r in port_over.items() if r > 1]
    got, ref = {"count": (len(beyond), sum(r > 1 for r in jax_over.values())),
                "factor": (max(port_over.values()), max(jax_over.values()))}[part]
    for name, value in (("port_beyond_jax", got), ("jax_beyond_port", ref), ("parameters", len(truth)),
                        ("port_parameters_beyond", " ".join(beyond))):
        request.node.user_properties.append((name, value))
    assert got <= ref, f"{part}: port against JAX {got}, JAX against the port {ref}; beyond: {beyond}"


# -- the contracts -----------------------------------------------------------------------------

def _step_once(compute_dtype, seed=0, family_version=1, ops=PLAIN_OPS, loss=None):
    model = piv_liteflownet(version=family_version, seed=seed, device="cpu")
    opt = make_optimizer(model, model.cfg.lowest_level)
    loss = loss or (tloss.piv_loss() if family_version == 1 else tloss.v2_multiscale())
    step = make_train_step(model.cfg, loss, opt, ops=ops, compute_dtype=compute_dtype)
    _, metrics = step(TrainState(model, opt), *_batch(1, 64, 64, seed=11))
    return model, opt, metrics


def test_bf16_step_keeps_float32_masters_and_adam_state():
    model, opt, metrics = _step_once(BF16)
    assert metrics["loss"].dtype == torch.float32 and bool(torch.isfinite(metrics["loss"]))
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    states = list(opt.state.values())
    assert len(states) == len(list(model.parameters()))
    for st in states:
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32


def test_bf16_forward_has_no_float32_activation():
    """Every module output in the bf16 train forward is bf16 (forward hooks, as
    tests/test_torch_bf16.py does for the eval forward); only the loss reads float32."""
    model = piv_liteflownet(version=2, seed=0, device="cpu")
    opt = make_optimizer(model, model.cfg.lowest_level)
    step = make_train_step(model.cfg, tloss.v2_multiscale(), opt, ops=PLAIN_OPS, compute_dtype=BF16)
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: seen.append(
        (name, [t.dtype for t in (out if isinstance(out, (list, tuple)) else [out]) if torch.is_tensor(t)])))
        for name, m in model.named_modules() if name]
    try:
        step(TrainState(model, opt), *_batch(1, 64, 64, seed=12))
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(d == BF16 for _, dtypes in seen for d in dtypes), \
        [s for s in seen if any(d != BF16 for d in s[1])][:5]


def test_float32_compute_dtype_is_the_float32_step():
    a_model, a_opt, a_metrics = _step_once(None)
    b_model, b_opt, b_metrics = _step_once(torch.float32)
    assert torch.equal(a_metrics["loss"], b_metrics["loss"])
    for (n, pa), pb in zip(a_model.named_parameters(), b_model.parameters()):
        assert torch.equal(pa.grad, pb.grad) and torch.equal(pa, pb), n


def test_other_compute_dtypes_raise():
    model = piv_liteflownet(seed=0, device="cpu")
    opt = make_optimizer(model, model.cfg.lowest_level)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_train_step(model.cfg, tloss.piv_loss(), opt, compute_dtype=dtype)


def _loaders(seed):
    train = []
    for i in range(2):
        im1, im2, t = _batch(1, 64, 64, seed + i)
        train.append(((im1, im2), t))
    im1, im2, t = _batch(1, 64, 64, seed + 9)
    return {"train": train, "val": [((im1, im2), t)]}


def _trainer(save, total_epochs, workdir):
    args = TrainArgs(total_epochs=total_epochs, backup_frequency=1, save=save, bf16=True,
                     lr_scheduler_kwargs={"milestones": [1], "gamma": 0.5})
    model = piv_liteflownet(seed=5, device="cpu")
    opt = make_optimizer(model, model.cfg.lowest_level)
    loss_obj = tloss.piv_loss(norm="L2")
    step = make_train_step(model.cfg, loss_obj, opt, compute_dtype=BF16 if args.bf16 else None)
    return Train(args, Experiment(workdir=workdir), _loaders(3), TrainState(model, opt), step,
                 make_eval_step(model.cfg, loss_obj))


@pytest.mark.parametrize("bf16", [False, True])
def test_train_refuses_a_step_of_another_precision(bf16, tmp_path):
    """``TrainArgs.bf16`` and the step's ``compute_dtype`` must agree: ``Train`` takes no step of
    the other precision."""
    model = piv_liteflownet(seed=5, device="cpu")
    opt = make_optimizer(model, model.cfg.lowest_level)
    loss_obj = tloss.piv_loss()
    step = make_train_step(model.cfg, loss_obj, opt, compute_dtype=None if bf16 else BF16)
    assert step.compute_dtype == (torch.float32 if bf16 else BF16)
    with pytest.raises(ValueError, match="compute_dtype"):
        Train(TrainArgs(bf16=bf16, save=str(tmp_path)), Experiment(workdir=str(tmp_path)), _loaders(3),
              TrainState(model, opt), step,
              make_eval_step(model.cfg, loss_obj))


def test_bf16_train_checkpoints_float32_and_resumes(tmp_path):
    """2 bf16 epochs of 2 steps == 1 epoch + resume from ``backup_1`` + 1 epoch, with float32
    params and Adam moments in every checkpoint."""
    a = _trainer(str(tmp_path / "a"), 2, str(tmp_path / "exp"))
    a()
    b = _trainer(str(tmp_path / "b"), 1, str(tmp_path / "exp"))
    b()
    c = _trainer(str(tmp_path / "b"), 2, str(tmp_path / "exp"))
    resume(c.state, str(tmp_path / "b" / "backup_1"), c.args)
    assert c.args.start_epoch == 2 and c.state.step == 2
    c()
    ck_a = restore_checkpoint(str(tmp_path / "a" / "backup_2"))
    ck_b = restore_checkpoint(str(tmp_path / "b" / "backup_2"))
    assert ck_a["step"] == ck_b["step"] == 4
    for k, v in ck_a["model"].items():
        assert v.dtype == torch.float32, k
        torch.testing.assert_close(ck_b["model"][k], v, rtol=0, atol=0, msg=k)
    sa, sb = ck_a["optimizer"]["state"], ck_b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq"):
            assert sa[i][key].dtype == torch.float32
            torch.testing.assert_close(sb[i][key], sa[i][key], rtol=0, atol=0)
    assert "backup_2.meta.json" in os.listdir(tmp_path / "a")


# -- the kernel path without a card --------------------------------------------------------

def _fake_kernels(monkeypatch):
    """Every op on its kernel path on the CPU: ``on_cuda`` says yes and each launch runs the
    plain version, the backward ones the kernels' contract: the float32 formula on the inputs
    upcast, each output rounded once. Records the dtype of every launch."""
    seen = []

    def fwd(plain):
        def launch(*args):
            *ins, out = args
            seen.append(out.dtype)
            out.copy_(plain(*ins))
        return launch

    def fake_warp_bwd(img, flow, gout, stride, g_img, g_flow):
        seen.append(g_img.dtype)
        a, b = warp.backwarp_bwd_plain(img.float(), flow.float(), gout.float(), stride)
        g_img.copy_(a)
        g_flow.copy_(b)

    def fake_corr_bwd(f1, f2, g, g_f1, g_f2):
        seen.append(g_f1.dtype)
        a, b = correlation.corr49_bwd_plain(f1.float(), f2.float(), g.float())
        g_f1.copy_(a)
        g_f2.copy_(b)

    monkeypatch.setattr(kernels, "on_cuda", lambda op, *tensors: True)
    monkeypatch.setattr(correlation, "_launch", fwd(correlation.corr49_plain))
    monkeypatch.setattr(warp, "_launch", fwd(warp.backwarp_plain))
    monkeypatch.setattr(rgb_warp, "_launch", fwd(rgb_warp.rgb_warp_norm_plain))
    monkeypatch.setattr(warp, "_launch_bwd", fake_warp_bwd)
    monkeypatch.setattr(correlation, "_launch_bwd", fake_corr_bwd)
    for mod in (correlation, warp, rgb_warp):
        monkeypatch.setattr(mod, "launches", 0)
        monkeypatch.setattr(mod, "bf16_launches", 0)
    for mod in (correlation, warp):
        monkeypatch.setattr(mod, "bwd_launches", 0)
        monkeypatch.setattr(mod, "bwd_bf16_launches", 0)
    return seen


@pytest.mark.parametrize("version,fwd,bwd", [(1, (6, 11, 6), (11, 6)), (2, (5, 9, 5), (9, 5))])
def test_bf16_step_through_faked_kernels(monkeypatch, version, fwd, bwd):
    """A bf16 step on the kernel path launches only the ``_bf16`` forms; its loss equals the plain
    path's, and its gradients hold the step relation against the plain path's, both held to the
    float32 step's."""
    f32_model, _, _ = _step_once(None, family_version=version)
    plain_model, _, plain_metrics = _step_once(BF16, family_version=version)
    seen = _fake_kernels(monkeypatch)
    model, _, metrics = _step_once(BF16, family_version=version, ops=KERNEL_OPS)
    mods = (correlation, warp, rgb_warp)
    assert tuple(m.bf16_launches for m in mods) == fwd
    assert (warp.bwd_bf16_launches, correlation.bwd_bf16_launches) == bwd
    assert tuple(m.launches for m in mods) == (0, 0, 0)
    assert (warp.bwd_launches, correlation.bwd_launches) == (0, 0)
    assert seen and set(seen) == {BF16}
    assert float(metrics["loss"]) == float(plain_metrics["loss"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    truth = {n: p.grad for n, p in f32_model.named_parameters()}
    relation = grad_relation(grads, {n: p.grad for n, p in plain_model.named_parameters()}, truth)
    for part, (err, ref_err, bound) in relation.items():
        assert err <= bound, f"{part}: kernel path {err:.4e}, plain path {ref_err:.4e}, bound {bound:.4e}"


def test_bf16_backward_launch_arguments(monkeypatch):
    """Each backward wrapper calls its ``_bf16`` entry point with the float32 form's arguments;
    the warp gradient's with its count of slow-path rectangles in the counter's place and, after
    it, the int32 boxes of its owner rectangles (4 each)."""
    calls, workspaces = [], []
    real_empty = torch.empty

    def spy_empty(*args, **kw):
        t = real_empty(*args, **kw)
        workspaces.append(t)
        return t

    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    for dtype in (torch.float32, BF16):
        img, flow = torch.zeros(2, 3, 9, 8, dtype=dtype), torch.zeros(2, 2, 5, 4, dtype=dtype)
        gout, g_img, g_flow = torch.zeros(2, 3, 5, 4, dtype=dtype), torch.zeros_like(img), torch.zeros_like(flow)
        monkeypatch.setattr(torch, "empty", spy_empty)
        warp._launch_bwd(img, flow, gout, 2, g_img, g_flow)
        monkeypatch.setattr(torch, "empty", real_empty)
        f1, f2, g = torch.zeros(2, 3, 5, 8, dtype=dtype), torch.zeros(2, 3, 5, 8, dtype=dtype), torch.zeros(2, 49, 5, 8, dtype=dtype)
        g_f1, g_f2 = torch.zeros_like(f1), torch.zeros_like(f2)
        correlation._launch_bwd(f1, f2, g, g_f1, g_f2)
    (w32, c32), (w16, c16) = calls[:2], calls[2:]
    assert [w32[0], c32[0], w16[0], c16[0]] == ["pivk_backwarp_bwd_f32", "pivk_corr49_bwd_f32",
                                                "pivk_backwarp_bwd_bf16", "pivk_corr49_bwd_bf16"]
    assert c16[1:3] == c32[1:3] and c16[3:] == (f1.data_ptr(), f2.data_ptr(), g.data_ptr(), g_f1.data_ptr(),
                                                g_f2.data_ptr(), correlation.edge_tile_counter(f1.device).data_ptr(),
                                                2, 3, 5, 8)
    assert build.SIGNATURES["pivk_corr49_bwd_bf16"] == build.SIGNATURES["pivk_corr49_bwd_f32"]
    # the warp gradient: the f32 form's arguments, its own counter, and the boxes after it
    assert len(workspaces) == 1 and workspaces[0].dtype == torch.int32
    assert tuple(workspaces[0].shape) == (2, *warp.owner_grid(9, 8), 4)
    assert w16[3:9] == (img.data_ptr(), flow.data_ptr(), gout.data_ptr(), g_img.data_ptr(), g_flow.data_ptr(),
                        warp.slow_rect_counter(img.device).data_ptr())
    assert w16[9] == workspaces[0].data_ptr() and w16[10:] == (2, 3, 9, 8, 5, 4, 2)
    assert len(w16) == len(w32) + 1
    sig32, sig16 = build.SIGNATURES["pivk_backwarp_bwd_f32"], build.SIGNATURES["pivk_backwarp_bwd_bf16"]
    assert sig16 == sig32[:6] + (sig32[0],) + sig32[6:]
    for name, source in (("pivk_backwarp_bwd_bf16", "backwarp_bwd.cu"), ("pivk_corr49_bwd_bf16", "corr49_bwd_bf16.cu")):
        assert f'extern "C" int {name}(' in (CSRC / source).read_text()


# -- the cost-volume backward's bf16 tile rule and layout -----------------------------------

def test_corr49_bwd_bf16_tile_rule_mirrors_the_source():
    for w in (8, 16, 128):
        assert not correlation.tile_plan(2, 8, w, backward=True, dtype=BF16).edge
    for w in (4, 12, 36, 53):  # 4 | w is not enough for bf16
        assert correlation.tile_plan(2, 8, w, backward=True, dtype=BF16).edge
    assert correlation.tile_plan(2, 8, 16, backward=True, aligned=False, dtype=BF16).edge
    plan = correlation.tile_plan(8, 128, 128, backward=True, dtype=BF16)
    # the bf16 tiles start at x = -4 (their windows on the 16-byte grid): 5 tile columns over 128
    assert plan.batch == 16 and plan.x0 == [-4, 28, 60, 92, 124] and plan.n_tiles == 16 * 5 * 16
    assert plan.smem <= correlation.SMEM_LIMIT
    stated32 = re.search(r"constexpr int SMEM = .*// ([\d,]+) bytes in f32", (CSRC / "corr49_bwd.cu").read_text())
    stated16 = re.search(r"constexpr int SMEM = .*// ([\d,]+) bytes", (CSRC / "corr49_bwd_bf16.cu").read_text())
    assert [int(m.group(1).replace(",", "")) for m in (stated32, stated16)] == [
        correlation.smem_bytes(True), correlation.smem_bytes(True, BF16)]


def _emulate_backward_bf16(f1, f2, g):
    """``csrc/corr49_bwd_bf16.cu``'s windows in bf16 (float64 here, on bf16 values): tiles of 32x8
    from x = -4; per tile the map's box, columns x0-4 .. x0+35 of rows y0-3 .., and g's windows
    (plane d: the same columns of rows y0 .. for g_f1, of rows y0-dy .. for g_f2); output pixel p
    of the tile meets box column p+4+dx (g_f1: g at its own pixel, plane (dy, dx)) or p+4-dx (g_f2:
    g at that column, plane (dy, dx) read from rows shifted by -dy); summed in one f64 sum."""
    b, c, h, w = f1.shape
    tw, th = 32, 8
    ny, nx = -(-h // th), -(-(w + 4) // tw)

    def boxes(t, top, height):  # per tile: rows y0-top .., columns x0-4 .. x0+35 (x0 = 32k - 4)
        p = F.pad(t, (8, nx * tw - w + 40, 8, ny * th - h + height + 8))[:, :, 8 - top:, :]
        return p.unfold(2, height, th).unfold(3, tw + 8, tw)[:, :, :ny, :nx]

    maps = (boxes(f2, 3, th + 6), boxes(f1, 3, th + 6))
    g_own = boxes(g, 0, th)                                      # g_f1: rows from y0
    g_shifted = [boxes(g, dyi - 3, th) for dyi in range(7)]      # g_f2: rows from y0 - dy
    outs = torch.zeros(2, b, c, ny * th, nx * tw, dtype=torch.float64)
    for o in range(2):
        for ty in range(th):
            for px in range(tw):
                acc = torch.zeros(b, c, ny, nx, dtype=torch.float64)
                for dyi in range(7):
                    for dxi in range(7):
                        d = dyi * 7 + dxi
                        if o == 0:  # g at the pixel, the map at (ty + dy, px + dx)
                            wt = g_own[:, d, :, :, ty, px + 4]
                            v = maps[0][..., ty + dyi, px + 4 + dxi - 3]
                        else:  # g at (ty - dy, px - dx) from the window of rows shifted by -dy
                            wt = g_shifted[dyi][:, d, :, :, ty, px + 4 - (dxi - 3)]
                            v = maps[1][..., ty + 6 - dyi, px + 4 - (dxi - 3)]
                        acc += wt[:, None] * v
                outs[o, :, :, ty::th, px::tw] = acc / c
    return outs[0, :, :, :h, 4:4 + w], outs[1, :, :, :h, 4:4 + w]


@pytest.mark.parametrize("shape", [(1, 4, 10, 40), (1, 8, 9, 16)])
def test_corr49_bwd_bf16_layout_replayed_matches_plain(shape):
    """The bf16 layout's index arithmetic on bf16 values in float64 (exact: the channel count is a
    power of 2), rounded to bf16 as the kernel rounds its f32 sums, equals the plain gradient."""
    rng = np.random.default_rng(shape[3])
    f1, f2 = (torch.from_numpy(rng.standard_normal(shape)).to(BF16).double() for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((shape[0], 49, *shape[2:]))).to(BF16).double()
    want = correlation.corr49_bwd_plain(f1, f2, g)
    for got, ref in zip(_emulate_backward_bf16(f1, f2, g), want):
        torch.testing.assert_close(got.to(BF16), ref.to(BF16), rtol=0, atol=0)


def test_breakdown_groups_the_bf16_backward_and_transposes():
    from piv_liteflownet_tpu_torch.breakdown import group_of, summarize

    assert group_of("void (anonymous namespace)::backwarp_bwd_kernel<1, __nv_bfloat16>(...)") == "backwarp_bwd"
    assert group_of("void (anonymous namespace)::own::backwarp_bwd_owner_kernel<2>(...)") == "backwarp_bwd"
    assert group_of("void (anonymous namespace)::own::owner_boxes_kernel<1>(...)") == "backwarp_bwd"
    assert group_of("(anonymous namespace)::stg::backwarp_staged_kernel(__nv_bfloat16 const*, ...)") == "backwarp"
    assert group_of("void (anonymous namespace)::corr49_bwd_bf16_kernel<true>(...)") == "corr49_bwd"
    assert group_of("void (anonymous namespace)::corr49_bf16_kernel<true>(...)") == "corr49"
    out = summarize([("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", 0, 1000),
                     ("sm90_xmma_fprop_implicit_gemm_bf16", 1000, 4000)], calls=1)
    assert out["device_ms_per_call"] == {"conv": 4.0}
    assert out["conv_layout_transposes_ms_per_call"] == 1.0


# -- on the card ---------------------------------------------------------------------------

def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (t a bf16 reference, as float32)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def _hold_to_reference(got: torch.Tensor, f32_plain: torch.Tensor, f32_tol: float, what: str) -> None:
    """|got - ref| <= ulp(ref) + f32_tol elementwise, ref the float32 plain result rounded to bf16."""
    assert got.dtype == BF16, what
    ref = f32_plain.to(BF16).float()
    err = (got.float() - ref).abs()
    bad = err > _bf16_ulp(ref) + f32_tol
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} values off, max err {float(err.max()):.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w,stride,mag", [
    (8, 64, 256, 256, 1, 2.0), (2, 64, 128, 160, 2, 2.0), (2, 5, 37, 53, 1, 30.0), (2, 7, 37, 53, 2, 30.0),
    (1, 16, 96, 128, 1, 30.0), (2, 33, 41, 67, 1, 8.0), (2, 33, 41, 67, 2, 30.0), (1, 5, 64, 96, 2, 8.0)])
def test_backwarp_bwd_bf16_kernel_matches_rounded_f32_plain(cuda, b, c, h, w, stride, mag):
    gen = torch.Generator(device=cuda).manual_seed(c + stride)
    img = torch.randn(b, c, h, w, device=cuda, generator=gen).to(BF16).requires_grad_()
    ho, wo = warp.out_hw(h, w, stride)
    flow = ((torch.rand(b, 2, ho, wo, device=cuda, generator=gen) * 2 - 1) * mag).to(BF16).requires_grad_()
    gout = torch.randn(b, c, ho, wo, device=cuda, generator=gen).to(BF16)
    counter = warp.slow_rect_counter(cuda)
    counter.zero_()
    before = warp.bwd_bf16_launches
    warp.backwarp(img, flow, stride).backward(gout)
    torch.cuda.synchronize()
    assert warp.bwd_bf16_launches == before + 1
    assert int(counter.item()) == warp.slow_rectangles(flow.detach().float(), h, w, stride)
    g_img, g_flow = torch.empty_like(img), torch.empty_like(flow)  # a second launch is bit-equal
    warp._launch_bwd(img.detach(), flow.detach(), gout, stride, g_img, g_flow)
    torch.cuda.synchronize()
    assert torch.equal(g_img.view(torch.int16), img.grad.view(torch.int16))
    assert torch.equal(g_flow.view(torch.int16), flow.grad.view(torch.int16))
    want_img, want_flow = warp.backwarp_bwd_plain(img.detach().float(), flow.detach().float(), gout.float(), stride)
    tol = 1e-5 * max(float(want_img.abs().max()), float(want_flow.abs().max()), 1.0)
    _hold_to_reference(img.grad, want_img, tol, f"g_img [{b},{c},{h},{w}] stride {stride}")
    _hold_to_reference(flow.grad, want_flow, tol, f"g_flow [{b},{c},{h},{w}] stride {stride}")


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w", [(8, 64, 128, 128), (2, 3, 37, 53), (1, 64, 64, 36), (1, 192, 8, 8),
                                     (2, 5, 2, 3), (1, 1, 1, 1)])
def test_corr49_bwd_bf16_kernel_matches_rounded_f32_plain(cuda, b, c, h, w):
    gen = torch.Generator(device=cuda).manual_seed(c + h)
    f1, f2 = (torch.randn(b, c, h, w, device=cuda, generator=gen).to(BF16).requires_grad_() for _ in range(2))
    g = torch.randn(b, 49, h, w, device=cuda, generator=gen).to(BF16)
    out = correlation.corr49(f1, f2)
    counter = correlation.edge_tile_counter(cuda)
    torch.cuda.synchronize()
    counter.zero_()
    before = correlation.bwd_bf16_launches
    out.backward(g)
    torch.cuda.synchronize()
    assert correlation.bwd_bf16_launches == before + 1
    plan = correlation.tile_plan(b, h, w, backward=True, dtype=BF16)
    assert int(counter.item()) == (plan.n_tiles if plan.edge else 0)
    want1, want2 = correlation.corr49_bwd_plain(f1.detach().float(), f2.detach().float(), g.float())
    tol = 1e-5 * max(float(want1.abs().max()), float(want2.abs().max()), 1.0)
    _hold_to_reference(f1.grad, want1, tol, f"g_f1 [{b},{c},{h},{w}]")
    _hold_to_reference(f2.grad, want2, tol, f"g_f2 [{b},{c},{h},{w}]")


@pytest.mark.gpu
@pytest.mark.parametrize("version", [1, 2])
def test_bf16_train_step_on_card_uses_bf16_kernels(cuda, version):
    """One bf16 step through the kernels and one through the plain ops on the card, from the same
    weights, both held to the float32 plain step under the step relation; only ``_bf16`` forms
    launch."""
    batch = _batch(2, 64, 96, seed=4)
    loss = tloss.piv_loss if version == 1 else tloss.v2_multiscale
    grads, losses = {}, {}
    for name, ops, dtype in (("f32", PLAIN_OPS, None), ("plain", PLAIN_OPS, BF16), ("kernel", KERNEL_OPS, BF16)):
        model = piv_liteflownet(version=version, seed=0, device=cuda)
        opt = make_optimizer(model, model.cfg.lowest_level)
        step = make_train_step(model.cfg, loss(), opt, ops=ops, compute_dtype=dtype)
        for mod in (correlation, warp, rgb_warp):
            mod.launches = mod.bf16_launches = 0
        for mod in (correlation, warp):
            mod.bwd_launches = mod.bwd_bf16_launches = 0
        _, metrics = step(TrainState(model, opt), *batch)
        torch.cuda.synchronize()
        losses[name] = float(metrics["loss"])
        grads[name] = {n: p.grad.clone() for n, p in model.named_parameters()}
    fwd = (6, 11, 6) if version == 1 else (5, 9, 5)
    assert tuple(m.bf16_launches for m in (correlation, warp, rgb_warp)) == fwd
    assert (warp.bwd_bf16_launches, correlation.bwd_bf16_launches) == fwd[1::-1]
    assert (correlation.launches, warp.launches, rgb_warp.launches, warp.bwd_launches,
            correlation.bwd_launches) == (0, 0, 0, 0, 0)
    assert abs(losses["kernel"] - losses["f32"]) <= 2 * abs(losses["plain"] - losses["f32"]) + 1e-3 * abs(losses["f32"])
    for part, (err, ref_err, bound) in grad_relation(grads["kernel"], grads["plain"], grads["f32"]).items():
        assert err <= bound, f"{part}: kernels {err:.4e}, plain {ref_err:.4e}, bound {bound:.4e}"
