"""Inference CLI of the port: ``python -m druggen_tpu_torch.inference``.

Same flags as the JAX package's ``inference.py`` plus ``--device``
(default ``cuda``).  Correction is not ported: pass ``--disable_correction``.
``--use_pallas`` serves through the whole-generator kernel (K9) instead of
the modules (``--fused_mlp`` then has no effect, as in JAX).

Example:
    python -m druggen_tpu_torch.inference --submodel DrugGEN \\
        --inference_model experiments/models/<run> \\
        --inf_smiles data/chembl_test.smi \\
        --train_smiles data/chembl_train.smi \\
        --train_drug_smiles data/akt_train.smi --sample_num 100 \\
        --inf_batch_size 512 --compute_dtype bfloat16 --fused_mlp \\
        --disable_correction
"""

from druggen_tpu_torch.config import parse_inference_args
from druggen_tpu_torch.infer.engine import InferenceEngine


def main(argv=None):
    cfg = parse_inference_args(argv)
    engine = InferenceEngine(cfg)
    return engine.run()


if __name__ == "__main__":
    main()
