"""The comparison that decides ``correct``: what the timed path produced,
against the plain float32 reference (TF32 off) in ``reference/``, which is
handed the same seeded weights and inputs and works out everything else.

Eval cells, per sampled volume:
* ``recon_gap``: the RMS of the system's reconstruction minus the
  reference's, over the RMS of the reference's (noise, encoder, UNet with its
  attention, ensemble mean); the worst volume.
* ``score_gap``: the reference's scoring of the system's own reconstruction
  against the system's scores (residual, post-processing, component filter,
  counts, threshold, metrics): the largest |a - b| / max(|b|, 1e-3) over
  the packed scalars and per-slice rows, and the residual's largest gap over
  its largest value; the worst volume. A test volume is scored with the
  threshold the harness handed its stage.
and per val stage drawn from the window's whole ones:
* ``threshold_gap``: |the threshold the system's ``test_end`` fitted - the
  reference's pooled fit over the system's reconstructions of every volume
  of the stage| / max(|reference's|, 1e-3).
Train cells, over the three set-up steps, and (``window_...``) over three
steps from a window step drawn from the seed, the reference starting from
the system's state there:
* ``loss_gap``: the largest |loss - reference loss| / |reference loss|;
* ``grad_gap``: the worst leaf's |norm - reference norm| of the first
  gradient (from Adam's first moment after one step: m1 / 0.1 from a fresh
  state, (m1 - 0.9 m0) / 0.1 in the window), over the larger of that leaf's
  reference norm and the median leaf's; ``grad_gap_median`` the median
  leaf's;
* ``update_gap``: the same of each parameter's and running statistic's
  change after three steps, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.diffusion import Adam, alpha_bars, augment_intensity, denoise, model_noise
from ..reference.diffusion import reconstruct_volume
from ..reference.model import CDDPM
from ..reference.noise import prng_key, volume_seeds
from ..reference.scoring import SCALAR_KEYS, pooled_threshold, score_volume
from .weights import make_weights

COMPARED_SCALARS = tuple(k for k in SCALAR_KEYS if k != "aux_loss")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def reference_model(cell, seed: int, device, quant=None) -> CDDPM:
    model = CDDPM(cell.config["model"], quant=quant).to(device)
    model.load_state_dict(make_weights(model.state_dict(), cell.weight_seed(seed), device))
    return model


def parse_scores(packed: np.ndarray, depth: int) -> dict:
    """The packed buffer's leading segments: 20 float32 scalars, then the
    per-slice rows [D, 5] (little-endian)."""
    buf = np.ascontiguousarray(packed, dtype=np.uint8)
    n = len(SCALAR_KEYS)
    scalars = np.frombuffer(buf[:4 * n].tobytes(), "<f4")
    per_slice = np.frombuffer(buf[4 * n:4 * n + 20 * depth].tobytes(), "<f4").reshape(depth, 5)
    return {"scalars": dict(zip(SCALAR_KEYS, map(float, scalars))),
            "per_slice": per_slice.astype(np.float64)}


def _rel(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
    return abs(a - b) / max(abs(b), 1e-3)


def score_gap(produced: dict, ref: dict, diff: torch.Tensor) -> float:
    gaps = [_rel(produced["scalars"][k], ref["scalars"][k]) for k in COMPARED_SCALARS]
    d = np.abs(produced["per_slice"] - ref["per_slice"]) / np.maximum(
        np.abs(ref["per_slice"]), 1e-3)
    gaps.append(float(d.max()))
    rd = ref["diff"]
    gaps.append(float((diff.float() - rd).abs().max() / rd.abs().max().clamp_min(1e-6)))
    return max(gaps)


def val_threshold(val: dict, rounding=None) -> float:
    """The reference's fit of a val stage's threshold from the system's
    reconstructions of its volumes (``rounding``: the control's)."""
    st = val["statics"]
    return pooled_threshold(val["vol"], val["reco"], val["mask"], val["seg"],
                            erode_iterations=st["erode_iterations"],
                            median_kernel=st["median_kernel"], rounding=rounding)


def threshold_gap(threshold: float, val: dict) -> float:
    return _rel(threshold, val_threshold(val))


def judge_eval(produced: dict, cell, seed: int, device) -> dict:
    """``recon_gap`` and ``score_gap`` of the sampled volumes (the worst, and
    each volume's under 'per_unit'), each sample a dict of the volume's
    inputs (vol, mask, seg, stage_index, th_record, statics) and the
    system's outputs (reco, diff, scores); ``threshold_gap`` of the val
    stage kept (its volumes' inputs, the system's reconstructions and the
    threshold it fitted)."""
    no_tf32()
    model_cfg = cell.config["model"]
    ref = reference_model(cell, seed, device)
    sched = alpha_bars(model_cfg["timesteps"])
    key = prng_key(cell.stage_key_seed(seed) + 1000)
    per_unit = []
    for s in produced["samples"]:
        seeds = volume_seeds(key, s["stage_index"], len(model_cfg["step_ensemble"]))
        reco_ref = reconstruct_volume(ref, s["vol"], seeds, model_cfg, sched)
        err = (s["reco"].float() - reco_ref).pow(2).mean().sqrt()
        recon = float(err / reco_ref.pow(2).mean().sqrt())
        st = s["statics"]
        ref_scores = score_volume(s["vol"], s["reco"], s["mask"], s["seg"], s["th_record"],
                                  erode_iterations=st["erode_iterations"],
                                  median_kernel=st["median_kernel"],
                                  cc_min_size=st["cc_min_size"])
        per_unit.append({"recon_gap": recon,
                         "score_gap": score_gap(s["scores"], ref_scores, s["diff"])})
    threshold = threshold_gap(produced["val"]["threshold"], produced["val"])
    per_unit.append({"threshold_gap": threshold})
    return {"recon_gap": max(u["recon_gap"] for u in per_unit[:-1]),
            "score_gap": max(u["score_gap"] for u in per_unit[:-1]),
            "threshold_gap": threshold, "per_unit": per_unit}


def reference_train(cell, seed: int, driver, device, quant=None, fault=None,
                    start: dict = None) -> dict:
    """The reference's three steps from the same weights, rows and draws:
    {'losses', 'grad_norms' (first step), 'change_norms' (after three)}.
    From the seeded weights and a fresh Adam on the feed's first rows, or
    from ``start``: a state taken in the window ('state', Adam's 'm', 'v'
    and 'step'), on the feed's rows after its first 'skip' batches.
    ``fault='half_batch'`` takes each step's loss over the first half of
    the batch alone."""
    no_tf32()
    model_cfg = cell.config["model"]
    ref = reference_model(cell, seed, device, quant)
    params = dict(ref.named_parameters())
    if start is None:
        opt = Adam(params.values(), model_cfg["lr"])
    else:
        ref.load_state_dict(start["state"])
        opt = Adam(params.values(), model_cfg["lr"], [start["m"][n] for n in params],
                   [start["v"][n] for n in params], start["step"])
    before = {k: v.clone() for k, v in ref.state_dict().items()}
    vols = driver.volumes()
    feed = driver.feed()
    for _ in range(start["skip"] if start else 0):
        feed.next()
    batches = []
    for _ in range(3):
        f = feed.next()
        f["x"] = vols[f["vi"], :, :, f["si"]][..., None].float()
        batches.append(f)
    del vols
    sched = alpha_bars(model_cfg["timesteps"])
    hw = tuple(cell.config["shape"][:2])
    losses, grads = [], None
    for k, f in enumerate(batches):
        for p in params.values():
            p.grad = None
        x = augment_intensity(f["x"], f["aug"])
        b = x.shape[0]
        rows = b // 2 if fault == "half_batch" else b
        ref.encoder.train()
        cond = ref.encoder(x)
        noise = model_noise(f["seed"].cpu().numpy(), hw, model_cfg, device)[0]
        noise = noise[None, :, :, None].expand(b, *hw, 1)
        per = denoise(ref, x[:rows], f["t"][:rows], cond[:rows], noise[:rows], sched)[0]
        loss = per.sum() / rows
        loss.backward()
        losses.append(float(loss.detach()))
        if k == 0:
            grads = {n: float(p.grad.norm()) for n, p in params.items()}
        opt.step()
    after = ref.state_dict()
    change = {n: float((after[n] - v).norm()) for n, v in before.items()}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def leaf_gaps(produced: dict, ref: dict) -> list:
    """(|norm - reference norm| / max(reference norm, median reference
    norm), leaf) for each leaf of ``ref``, largest first."""
    med = float(np.median(list(ref.values())))
    return sorted(((abs(produced[n] - r) / max(r, med), n) for n, r in ref.items()),
                  reverse=True)


def train_numbers(produced: dict, ref: dict, prefix: str = "") -> tuple:
    """(the numbers of three steps against the reference's, the leaves
    behind the worst gaps); the '_median' numbers are the median leaf's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(produced["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = float(np.median(list(g_ref.values())))
    quiet = {n for n, g in g_ref.items() if g < 1e-3 * g_med}
    grads = leaf_gaps(produced["grad_norms"], g_ref)
    changes = leaf_gaps(produced["change_norms"],
                        {n: c for n, c in ref["change_norms"].items() if n not in quiet})
    first = abs(produced["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    numbers = {"loss1_gap": first, "loss_gap": loss, "grad_gap": grads[0][0],
               "update_gap": changes[0][0],
               "grad_gap_median": float(np.median([g for g, _ in grads])),
               "update_gap_median": float(np.median([g for g, _ in changes]))}
    return ({prefix + k: v for k, v in numbers.items()},
            {prefix + "grad": grads[:3], prefix + "update": changes[:3]})


def judge_train(produced: dict, driver, device) -> dict:
    """The train cell's numbers: the three set-up steps from the seed, and
    (named 'window_...') the three steps from the state the window reached
    at its checked step."""
    ref = reference_train(driver.cell, driver.seed, driver, device)
    numbers, worst = train_numbers(produced, ref)
    win = produced["window"]
    ref_w = reference_train(driver.cell, driver.seed, driver, device, start=win["start"])
    numbers_w, worst_w = train_numbers(win, ref_w, "window_")
    numbers.update(numbers_w)
    return dict(numbers, per_unit=[dict(numbers)], worst_leaves=dict(worst, **worst_w))
