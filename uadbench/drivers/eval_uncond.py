"""Traffic driver ``eval_uncond``: the same test-time protocol as
``eval_protocol``, for an unconditional UNet reconstructing a volume in one
forward at t = test_timesteps (the DDPM baseline: ``condition: false``,
``noise_ensemble: false``), such as ADM-256.

What differs from ``EvalProtocol`` is what the model is, not the traffic:
* the work: the UNet alone, one forward a padded row, no encoder
  (``unet_forward``: the time embedding only, as the model has no label);
* the attention calls: every attention block of the encoder, the middle and
  the decoder, at its own tokens and channels;
* the check: the numbers of ``harness/checks.py::judge_eval`` against the
  plain float32 UNet of ``reference/adm.py``, with no encoder and one noise
  field a volume, and ``recon_input_gap`` beside ``recon_gap``: the RMS of
  the reconstruction's gap over the RMS of the volume it reconstructs. The
  random weights set the reference reconstruction's RMS (0.17-0.91 over 33
  weight seeds at 256x256x100), which ``recon_gap`` divides by, while the
  bf16 gap itself stays ~0.005; the volume's RMS (0.38-0.39) is the data's.
Over the traced slice it counts the attention blocks' calls (a forward hook
on each) and the K2 launches (``ops/attention.py``'s
``fused_attention.launches``, counted where a kernel launches), for
``eval.attn_k2_share``.
"""
from __future__ import annotations

from ..harness import flops
from ..harness.checks import no_tf32, score_gap, threshold_gap, val_threshold
from ..harness.weights import make_weights
from ..reference.adm import ADM, reconstruct_volume
from ..reference.diffusion import alpha_bars
from ..reference.noise import prng_key, volume_seeds
from ..reference.scoring import score_volume
from .eval_protocol import EvalProtocol, make_subjects


def attention_sites(model: dict, hw) -> list:
    """(tokens, channels) of each attention block of one UNet forward at
    ``hw``, in call order (encoder, middle, decoder)."""
    mc, mults, n = model["unet_dim"], list(model["channel_mult"]), model["num_res_blocks"]
    att = set(model["attention_resolutions"])
    top = len(mults) - 1

    def at(level):
        ds = 2 ** level
        return (hw[0] // ds) * (hw[1] // ds), mults[level] * mc

    sites = [at(level) for level in range(len(mults)) for _ in range(n) if 2 ** level in att]
    sites.append(at(top))
    sites += [at(level) for level in reversed(range(len(mults))) for _ in range(n + 1)
              if 2 ** level in att]
    return sites


def unet_forward(model: dict, hw) -> float:
    """Operations of one forward of the unconditional UNet on one row at
    ``hw`` (``harness/flops.py``'s counting: 2 a multiply-add of every
    convolution, linear layer and attention product): the time embedding,
    scale-shift ResBlocks fed the 4 * model_channels embedding, the
    resampling ResBlocks at their output's resolution, no label."""
    mc = model["unet_dim"]
    emb = 4 * mc
    h, w = hw
    total = 2.0 * (mc * emb + emb * emb) + flops._conv(h, w, 1, mc, 3)

    def res(hh, ww, cin, cout):
        t = flops._conv(hh, ww, cin, cout, 3) + flops._conv(hh, ww, cout, cout, 3)
        t += 2.0 * emb * 2 * cout
        return t + (flops._conv(hh, ww, cin, cout, 1) if cin != cout else 0.0)

    skips, ch = [mc], mc
    mults = list(model["channel_mult"])
    for level, mult in enumerate(mults):
        for _ in range(model["num_res_blocks"]):
            total += res(h, w, ch, mult * mc)
            ch = mult * mc
            skips.append(ch)
        if level != len(mults) - 1:
            h, w = h // 2, w // 2
            total += res(h, w, ch, ch)
            skips.append(ch)
    total += 2 * res(h, w, ch, ch)
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(model["num_res_blocks"] + 1):
            total += res(h, w, ch + skips.pop(), mult * mc)
            ch = mult * mc
            if level and i == model["num_res_blocks"]:
                h, w = 2 * h, 2 * w
                total += res(h, w, ch, ch)
    total += sum(flops.attention_flops(s, c) for s, c in attention_sites(model, hw))
    return total + flops._conv(hw[0], hw[1], ch, 1, 3)


def recon_numbers(reco, reco_ref, vol) -> dict:
    """The RMS of ``reco - reco_ref`` over the reference's RMS
    (``recon_gap``) and over the volume's (``recon_input_gap``)."""
    err = (reco.float() - reco_ref).pow(2).mean().sqrt()
    return {"recon_gap": float(err / reco_ref.pow(2).mean().sqrt()),
            "recon_input_gap": float(err / vol.float().pow(2).mean().sqrt())}


def reference_model(cell, seed: int, device, quant=None) -> ADM:
    model = ADM(cell.config["model"], quant=quant).to(device)
    model.load_state_dict(make_weights(model.state_dict(), cell.weight_seed(seed), device))
    return model


def judge(produced: dict, cell, seed: int, device) -> dict:
    """``harness/checks.py::judge_eval``'s numbers with the unconditional
    reference: each sampled volume reconstructed by ``reference/adm.py``
    from the volume's one field, the same scoring and val threshold; and
    ``recon_input_gap``, the reconstruction's RMS gap over the RMS of the
    volume (the worst sampled volume)."""
    no_tf32()
    model_cfg = cell.config["model"]
    ref = reference_model(cell, seed, device)
    sched = alpha_bars(model_cfg["timesteps"])
    key = prng_key(cell.stage_key_seed(seed) + 1000)
    per_unit = []
    for s in produced["samples"]:
        (vol_seed,) = volume_seeds(key, s["stage_index"], 1)
        reco_ref = reconstruct_volume(ref, s["vol"], vol_seed, model_cfg, sched)
        st = s["statics"]
        ref_scores = score_volume(s["vol"], s["reco"], s["mask"], s["seg"], s["th_record"],
                                  erode_iterations=st["erode_iterations"],
                                  median_kernel=st["median_kernel"],
                                  cc_min_size=st["cc_min_size"])
        per_unit.append(dict(recon_numbers(s["reco"], reco_ref, s["vol"]),
                             score_gap=score_gap(s["scores"], ref_scores, s["diff"])))
    th = threshold_gap(produced["val"]["threshold"], produced["val"])
    per_unit.append({"threshold_gap": th})
    worst = {k: max(u[k] for u in per_unit[:-1])
             for k in ("recon_gap", "recon_input_gap", "score_gap")}
    return dict(worst, threshold_gap=th, per_unit=per_unit)


def stand_in(cell, seed: int, device, quant, rounding) -> dict:
    """The control: the reference in the system's place (``quant`` in its
    products and norms, ``rounding`` in its scoring) over the volumes a run
    checks (the pool's first ``check_groups`` groups, the search's own
    threshold), those volumes taken as the val stage whose threshold it
    fits; what ``judge`` reads."""
    no_tf32()
    p, m = cell.params, cell.config["model"]
    shape = tuple(cell.config["shape"])
    pool = make_subjects(p["check_groups"] * p["volumes_per_call"], shape,
                         cell.input_seed(seed), p["lesion_share"], p["lesions"], device)
    model = reference_model(cell, seed, device, quant)
    sched = alpha_bars(m["timesteps"])
    key = prng_key(cell.stage_key_seed(seed) + 1000)
    statics = {"erode_iterations": shape[1] // 25, "median_kernel": 5, "cc_min_size": 8}
    out = []
    for i, sub in enumerate(pool):
        dev = sub["_dev"]
        reco = reconstruct_volume(model, dev["vol"], volume_seeds(key, i, 1)[0], m, sched)
        scores = score_volume(dev["vol"], reco, dev["mask_orig"], dev["seg_orig"],
                              float("nan"), rounding=rounding, **statics)
        out.append({"vol": dev["vol"], "mask": dev["mask_orig"], "seg": dev["seg_orig"],
                    "stage_index": i, "th_record": float("nan"), "statics": statics,
                    "reco": reco, "diff": scores["diff"], "scores": scores})
    val = {k: [s[k] for s in out] for k in ("vol", "mask", "seg", "reco")}
    val["statics"] = statics
    val["threshold"] = val_threshold(val, rounding)
    return {"samples": out, "val": val}


class UncondEvalProtocol(EvalProtocol):
    def traced_slice(self) -> int:
        """The base slice, counting its attention blocks' calls and its K2
        launches into ``traced_attention`` ({'calls', 'k2'})."""
        from conditioned_diffusion_models_uad_torch.models.unet import AttentionBlock
        from conditioned_diffusion_models_uad_torch.ops import attention

        counted = {"calls": 0}

        def count(module, args):
            counted["calls"] += 1

        hooks = [m.register_forward_pre_hook(count) for m in self.task.unet.modules()
                 if isinstance(m, AttentionBlock)]
        before = attention.fused_attention.launches
        try:
            n = super().traced_slice()
        finally:
            for h in hooks:
                h.remove()
        self.traced_attention = dict(counted, k2=attention.fused_attention.launches - before)
        return n

    def work_flops(self, volumes: int) -> float:
        return volumes * self.padded_depth() * unet_forward(self.model_cfg, self.shape[:2])

    def attention_calls(self, volumes: int) -> list:
        """(rows, tokens, channels) of every attention block call for
        ``volumes`` volumes: each block once a volume, at its padded rows."""
        rows = self.padded_depth()
        return [(rows, s, c) for s, c in attention_sites(self.model_cfg, self.shape[:2])
                ] * volumes

    def check_numbers(self, samples) -> dict:
        return judge(samples, self.cell, self.seed, self.device)

