"""Offline dataset-preparation CLI over ``data/preprocessing.py`` (counterpart
of ``conditioned_diffusion_models_uad_tpu/data/prepare_cli.py``; reference
prepare_IXI.sh / prepare_Brats21.sh / prepare_MSLUB.sh):

    python -m conditioned_diffusion_models_uad_torch.data.prepare_cli \\
        --dataset IXI --input /raw/IXI --output $DATA_DIR/Data/IXI \\
        [--atlas /path/SRI24.nii.gz] [--threads 4] [--device cpu] [--report FILE]

Input: a directory of NIfTI images (*.nii / *.nii.gz); ``--seg-suffix``
pairs segmentation files for lesion datasets (e.g. BraTS ``_seg``). Output:
``<name>_t1.nii.gz``, ``<name>_mask.nii.gz`` (and ``<name>_seg.nii.gz``) per
subject. The stages run on the CUDA card unless ``--device cpu``;
``--report`` writes one JSON line a subject (stage seconds, the fitted
affine and the registration's losses).
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=("IXI", "Brats21", "MSLUB"), required=True)
    p.add_argument("--input", required=True, help="directory of raw NIfTI images")
    p.add_argument("--output", required=True)
    p.add_argument("--atlas", default=None,
                   help="atlas NIfTI for affine registration (e.g. SRI24)")
    p.add_argument("--seg-suffix", default="_seg",
                   help="suffix marking segmentation files to pair + carry")
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device of the array stages (default: the CUDA card)")
    p.add_argument("--report", default=None,
                   help="write one JSON line a subject (stage seconds, affine) here")
    args = p.parse_args(argv)

    from ..utils.device import resolve_device
    from ..utils.prefetch import PrefetchLoader
    from .nifti import read_nifti
    from .preprocessing import DATASET_STAGES, prepare_subject

    device = resolve_device(args.device)  # no CUDA and no --device cpu: raise here
    cfg = DATASET_STAGES[args.dataset]
    atlas = None
    if args.atlas:
        atlas, _ = read_nifti(args.atlas)
        cfg = dataclasses.replace(cfg, register=True)

    imgs = sorted(
        f for f in glob.glob(os.path.join(args.input, "*.nii*"))
        if args.seg_suffix not in os.path.basename(f)
    )
    if not imgs:
        print(f"no NIfTI images found in {args.input}", file=sys.stderr)
        return 1

    def seg_for(img):
        base = img
        for ext in (".nii.gz", ".nii"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                cand = f"{base}{args.seg_suffix}{ext}"
                if os.path.exists(cand):
                    return cand
        return None

    def run_one(img):
        report = {"subject": os.path.basename(img)}
        t0 = time.perf_counter()
        out = prepare_subject(img, args.output, cfg, atlas=atlas, seg_path=seg_for(img),
                              device=device, report=report)
        report["total_s"] = time.perf_counter() - t0
        return img, out, report

    reports = []
    done = 0
    for img, out, report in PrefetchLoader(imgs, run_one, num_threads=args.threads):
        done += 1
        reports.append(report)
        print(f"[{done}/{len(imgs)}] {os.path.basename(img)} -> {out['img']}")
    if args.report:
        with open(args.report, "w") as f:
            for r in reports:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
