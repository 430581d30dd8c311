"""Convert reference torch checkpoints to/from the JAX package's flax
checkpoints: ``python -m druggen_tpu_torch.import_torch_ckpt``.

Port of the JAX package's ``scripts/import_torch_ckpt.py``, with the same
flags and the same files, without flax (:mod:`.interop.msgpack_ckpt` writes
and reads flax msgpack).  The reference releases ``{submodel}-G.ckpt`` torch
state_dicts (restored at ``reference/inference.py:135-139``; saved at
``train.py:259-263``).  The port's models load such a file as they are
(``train.checkpoint.load_params_auto`` reads both formats); this tool writes
the msgpack param files the JAX package's engine and trainer load, and back.

Import the released AKT1 generator:

    python -m druggen_tpu_torch.import_torch_ckpt \\
        --model generator --input experiments/models/DrugGEN-G.ckpt \\
        --output experiments/models/DrugGEN-G.msgpack

Export a trained generator for the reference code:

    python -m druggen_tpu_torch.import_torch_ckpt --reverse \\
        --model generator --input mymodel/DrugGEN-G.ckpt \\
        --output DrugGEN-G.pt

The output of --reverse is a torch ``state_dict`` loadable by the reference
``Generator.load_state_dict`` (``reference/train.py:250-257``) and by the
port's.
"""

from __future__ import annotations

import argparse

import torch

from druggen_tpu_torch.interop import torch_ckpt as tc
from druggen_tpu_torch.interop.msgpack_ckpt import msgpack_restore, msgpack_serialize


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", required=True,
                   choices=["generator", "discriminator", "simple_disc"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--reverse", action="store_true",
                   help="flax msgpack -> torch .ckpt instead of torch -> flax")
    p.add_argument("--scan-layers", action="store_true",
                   help="emit the lax.scan stacked blocks/block layout")
    args = p.parse_args(argv)

    if args.reverse:
        with open(args.input, "rb") as f:
            variables = msgpack_restore(f.read())
        to_torch = {
            "generator": tc.flax_generator_to_torch,
            "discriminator": tc.flax_discriminator_to_torch,
            "simple_disc": tc.flax_simple_disc_to_torch,
        }[args.model]
        sd = tc.to_torch_tensors(to_torch(variables))
        torch.save(sd, args.output)
        print(f"wrote torch state_dict ({len(sd)} tensors) -> {args.output}")
        return 0

    sd = tc.load_torch_state_dict(args.input)
    if args.model == "generator":
        variables = tc.torch_generator_to_flax(sd, scan_layers=args.scan_layers)
    elif args.model == "discriminator":
        variables = tc.torch_discriminator_to_flax(
            sd, scan_layers=args.scan_layers)
    else:
        variables = tc.torch_simple_disc_to_flax(sd)
    with open(args.output, "wb") as f:
        f.write(msgpack_serialize(variables))
    print(f"wrote flax params -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
