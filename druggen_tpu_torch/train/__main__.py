"""Training CLI of the port: ``python -m druggen_tpu_torch.train``.

Takes the JAX CLI's flags (``train.py``, reference train.py:400-462) plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU with the
kernels' plain versions).

Example:
    python -m druggen_tpu_torch.train --raw_file data/chembl_train.smi \\
        --drug_raw_file data/akt_train.smi --submodel DrugGEN \\
        --batch_size 512 --epoch 35 --compute_dtype bfloat16 \\
        --fused_mlp --fused_critic
"""

from druggen_tpu_torch.config import parse_train_args
from druggen_tpu_torch.train.trainer import Trainer


def main(argv=None):
    cfg = parse_train_args(argv)
    Trainer(cfg).train()


if __name__ == "__main__":
    main()
