"""Weight converter CLI of the port: ``python -m piv_liteflownet_tpu_torch.convert``.

Modes (the JAX package's ``convert.py`` on the port's formats):

- ``--mode caffe``: a Caffe export's dict (``torch.load``-able) renamed by
  position onto the model's state-dict keys (``rename_caffe_keys``) and saved
  as the port's state dict;
- ``--mode torch2npz``: a state dict (``.paramOnly``) to the JAX package's
  ``.npz`` of params (``to_jax_params``);
- ``--mode npz2torch``: a JAX ``.npz`` to a state dict (``from_jax_params``).

Each mode checks the keys and shapes of what it writes (``validate_params``),
converts it back and requires the round trip to be bit-equal.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="LiteFlowNet weight converter")
    parser.add_argument("--mode", choices=["caffe", "torch2npz", "npz2torch"], default="torch2npz")
    parser.add_argument("--input", "-i", required=True, help="input weight file")
    parser.add_argument("--output", "-o", required=True, help="output file (.npz or .paramOnly)")
    parser.add_argument("--model", "-m", choices=["hui", "piv"], default="piv")
    parser.add_argument("--version", "-v", type=int, choices=[1, 2], default=1)
    args = parser.parse_args(argv)

    from piv_liteflownet_tpu_torch.models import convert as C
    from piv_liteflownet_tpu_torch.models.factory import config

    cfg = config(args.model, args.version)
    if args.mode == "npz2torch":
        with np.load(args.input) as data:
            params = dict(data)
        sd = C.from_jax_params(cfg, params)
        C.validate_params(cfg, sd)
        back = C.to_jax_params(cfg, sd)
        for k, v in params.items():
            if not np.array_equal(back[k], np.asarray(v, np.float32)):
                raise AssertionError(f"round trip changed {k}")
        torch.save(sd, args.output)
        print(f"wrote torch state dict: {args.output} ({len(sd)} tensors)")
        return args.output
    if args.mode == "caffe":
        raw = torch.load(args.input, map_location="cpu", weights_only=True)
        sd = {k: torch.as_tensor(v, dtype=torch.float32).contiguous()
              for k, v in C.rename_caffe_keys(cfg, raw).items()}
        C.validate_params(cfg, sd)
        torch.save(sd, args.output)
        back = torch.load(args.output, map_location="cpu", weights_only=True)
        if not all(torch.equal(back[k], v) for k, v in sd.items()):
            raise AssertionError("the saved state dict does not read back equal")
        print(f"wrote torch state dict: {args.output} ({len(sd)} tensors)")
        return args.output
    sd = C.load_param_only(cfg, args.input)
    C.validate_params(cfg, sd)
    params = C.to_jax_params(cfg, sd)
    back = C.from_jax_params(cfg, params)
    for k, v in sd.items():
        if not torch.equal(back[k], v):
            raise AssertionError(f"round trip changed {k}")
    np.savez(args.output, **params)
    print(f"wrote {args.output} ({len(params)} tensors)")
    return args.output


if __name__ == "__main__":
    main()
