"""Where the bf16 conv chain rounds: the TPU kernel's rule against a conv per layer in bf16.

The TPU kernel ``conv_chain_pallas`` in bf16 sums every tap and part in float32 and rounds
once per layer. For each chain below it prints, against that kernel in interpret mode on the
same bf16 values, how many outputs differ and by how much for (a) the port's plain bf16 chain,
``ops/conv_chain.py:conv_chain_plain``, which follows the kernel's rule, and (b) JAX's
reference ``conv_chain_xla`` run in bf16, which rounds per part and per conv. The chains are
a small three-layer one (parts [1,20,30,5+7], 3x3 12->16, 3x3 16->8, 5x5 8->2) and the
shapes of ``CASES`` in tests/test_torch_conv_chain.py, inputs from numpy seeds as there.

    JAX_PLATFORMS=cpu python tests/bf16_chain_rounding.py

About half a minute on the CPU. Not a test: pytest does not collect it.
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

from piv_liteflownet_tpu.ops.pallas_conv import conv_chain_pallas, conv_chain_xla  # noqa: E402
from piv_liteflownet_tpu_torch.ops.conv_chain import conv_chain_plain  # noqa: E402
from test_torch_conv_chain import CASES, _chain, _to_torch  # noqa: E402

SMALL = ([(3, 12, 16), (3, 16, 8), (5, 8, 2)], [5, 7], (1, 20, 30), True)


def compare(name, seed, shapes, parts_c, size, last_linear):
    parts, weights, biases = _chain(seed, shapes, parts_c, *size)
    jb = [[jnp.asarray(a, jnp.bfloat16) for a in arrays] for arrays in (parts, weights, biases)]
    kernel = np.asarray(conv_chain_pallas(*jb, last_linear=last_linear, tile_h=16, tile_w=24,
                                          interpret=True)).astype(np.float32)
    xla = np.asarray(conv_chain_xla(*jb, last_linear=last_linear)).astype(np.float32)
    tp = [[t.to(torch.bfloat16) for t in ts] for ts in _to_torch(parts, weights, biases)]
    port = conv_chain_plain(*tp, last_linear).float().permute(0, 2, 3, 1).numpy()
    line = [f"{name}: {kernel.size} outputs, max|kernel| {np.abs(kernel).max():.4g}"]
    for what, got in (("port's plain bf16 chain", port), ("conv_chain_xla in bf16", xla)):
        d = np.abs(got - kernel)
        line.append(f"{what}: {int((d > 0).sum())} differ, by up to {d.max():.4g}")
    print("; ".join(line), flush=True)


def main() -> None:
    compare("small 3-layer chain", 0, *SMALL)
    for name, (shapes, parts_c, size, last_linear, _) in CASES.items():
        compare(name, len(name), shapes, parts_c, size, last_linear)


if __name__ == "__main__":
    main()
