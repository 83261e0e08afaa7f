"""The port's CLI (counterpart of the repo's ``run.py``):

    python -m conditioned_diffusion_models_uad_torch experiment=cDDPM/DDPM_cond_spark_2D [key=value ...]

Composition: configs/config.yaml <- configs/experiment/<name>.yaml <- CLI
key=value overrides (dotted keys, YAML-typed values), from the repo's
``configs/`` tree. ``environment.env`` beside that tree is loaded into
os.environ first for ${env:DATA_DIR}/${env:LOG_DIR}. The run goes on the
CUDA card; ``device=cpu`` asks for the CPU, and without CUDA and without it
the run raises before it starts.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

USAGE = """usage: python -m conditioned_diffusion_models_uad_torch experiment=cDDPM/<name> [key=value ...]

experiments: cDDPM/DDPM_cond_spark_2D (north-star) | cDDPM/DDPM | cDDPM/test
             | cDDPM/DDPM_patched (pDDPM) | cDDPM/Spark_2D_pretrain (SparK
             pretraining of the encoder; then cDDPM/DDPM_cond_spark_2D
             pretrained_encoder=<that run's dir>)
overrides:   dotted keys with YAML-typed values, e.g.
             trainer.max_epochs=100 'model.step_ensemble=[250,500,750]'
             only_eval=true load_checkpoint=<run-dir> datamodule.mode=t2
             model.reco_mode=ddim|ancestral model.sampling_steps=50
             model.spatial_transformer=true (cross-attention conditioning)
             model.film_fold=true (with model.norm_precision=compute)
             model.dropout_unet=0.1 trainer.aug_full=true
             device=cpu (default: the CUDA card)
env:         DATA_DIR, LOG_DIR (or put them in environment.env)
raw data:    python -m conditioned_diffusion_models_uad_torch.data.prepare_cli
             --dataset IXI|Brats21|MSLUB --input <raw dir> --output <dir>
             [--atlas <nii>] [--device cpu]"""


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a in ("-h", "--help", "help") for a in argv):
        print(USAGE)
        return None

    from .config import compose, load_env_file, materialize, print_config, save_config
    from .orchestrate import train
    from .utils.device import resolve_device

    load_env_file(os.path.join(ROOT, "environment.env"))
    experiment = None
    overrides = []
    for a in argv:
        if a.startswith("experiment="):
            experiment = a.split("=", 1)[1]
        else:
            overrides.append(a)

    tree = compose(os.path.join(ROOT, "configs"), experiment, overrides)
    cfg = materialize(tree)
    resolve_device(cfg.device)  # no CUDA and no device=cpu: raise here

    os.makedirs(cfg.run_dir, exist_ok=True)
    print_config(tree, run_dir=cfg.run_dir)
    save_config(tree, os.path.join(cfg.run_dir, "final_config.yaml"))
    return train(cfg)


if __name__ == "__main__":
    main()
