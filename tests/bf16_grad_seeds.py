"""The per-parameter gradient relation of the bf16 train step at several seeds.

For each (model seed, batch seed): JAX's float32 and bf16 piv v1 steps and the
port's bf16 step at 64x96 b2, as ``tests/test_torch_bf16_train.py`` builds
them, and the port's bf16 step once more with the first conv of each S and R
stack summed per input part in bf16, as JAX's ``_cl_split`` sums it, instead
of one conv over the concat. For each pair of these three it prints, both
ways, on how many parameters the relation "error within max(2 x the other's,
0.02)" fails, the largest factor by which it fails, and the stacks of those
parameters. The whole-gradient and median errors go beside them.

    JAX_PLATFORMS=cpu python tests/bf16_grad_seeds.py 3,0 4,1 5,2

Each seed takes about a minute on the CPU. Not a test: pytest does not
collect it.
"""

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import test_torch_bf16_train as T  # noqa: E402
from piv_liteflownet_tpu_torch.models import liteflownet  # noqa: E402
from piv_liteflownet_tpu_torch.training.precision import grad_relation  # noqa: E402


def split_first_conv(stack, parts, ops, chain):
    """``liteflownet._run_stack`` with the first conv summed per part in the parts' dtype."""
    if len(parts) == 1 or chain:
        return concat_first_conv(stack, parts, ops, chain)
    conv, out, off = stack[0], None, 0
    for x in parts:
        c = x.shape[1]
        y = F.conv2d(x, conv.weight[:, off:off + c], None, 1, conv.padding)
        out = y if out is None else out + y
        off += c
    return stack[2:](stack[1](out + conv.bias[None, :, None, None]))


concat_first_conv = liteflownet._run_stack


def report(tag: str, got: dict, ref: dict, truth: dict) -> None:
    rel = grad_relation(got, ref, truth)
    line = [f"{tag}: whole {rel['whole'][0]:.4f} / {rel['whole'][1]:.4f}, "
            f"median {rel['median'][0]:.4f} / {rel['median'][1]:.4f}"]
    for a, b, name in ((got, ref, "first beyond second"), (ref, got, "second beyond first")):
        over = {n: r for n, r in T.per_parameter(a, b, truth).items() if r > 1}
        stacks = sorted({".".join(n.split(".")[:2]) for n in over})
        line.append(f"{name}: {len(over)} parameters, factor {max(T.per_parameter(a, b, truth).values()):.2f}, "
                    f"{' '.join(stacks)}")
    print("\n    ".join(line), flush=True)


def main(seeds) -> None:
    torch.set_num_threads(2)
    for pair in seeds:
        model_seed, batch_seed = map(int, pair.split(","))
        run = T.bf16_grads(model_seed, batch_seed)
        liteflownet._run_stack = split_first_conv
        try:
            split = T.port_bf16_step(run["params"], run["batch"])[1]
        finally:
            liteflownet._run_stack = concat_first_conv
        truth, jax, port = (run[k][1] for k in ("f32", "jax_bf16", "port_bf16"))
        print(f"model seed {model_seed}, batch seed {batch_seed}, {len(truth)} parameters")
        report("  port / JAX", port, jax, truth)
        report("  port with JAX's sums / JAX", split, jax, truth)
        report("  port / port with JAX's sums", port, split, truth)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    main(sys.argv[1:] or ["3,0", "4,1", "5,2"])
