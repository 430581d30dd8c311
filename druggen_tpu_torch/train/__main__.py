"""Training CLI of the port: ``python -m druggen_tpu_torch.train``.

Takes the JAX CLI's flags (``train.py``, reference train.py:400-462) plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU with the
kernels' plain versions).  Under ``torchrun --nproc_per_node K`` (or with
``--distributed``) each rank runs this; ``--mesh_data``, ``--mesh_node``
and ``--mesh_model`` lay the ranks out (``druggen_tpu_torch/parallel``).

Example:
    python -m druggen_tpu_torch.train --raw_file data/chembl_train.smi \\
        --drug_raw_file data/akt_train.smi --submodel DrugGEN \\
        --batch_size 512 --epoch 35 --compute_dtype bfloat16 \\
        --fused_mlp --fused_critic
"""

from druggen_tpu_torch.config import parse_train_args
from druggen_tpu_torch.parallel import mesh as pmesh
from druggen_tpu_torch.train.trainer import Trainer


def main(argv=None):
    cfg = parse_train_args(argv)
    Trainer(cfg).train()
    if pmesh.world()[1] > 1:
        # a rank of a parallel run: all ranks done, then exit at once
        pmesh.leave_group()


if __name__ == "__main__":
    main()
