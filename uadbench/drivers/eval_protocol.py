"""Traffic driver ``eval_protocol``: the paper's test-time protocol, closed
loop, through the system's own stage loop.

A pool of BraTS-like subjects is made on the device from the seed (an
ellipsoid brain of smoothed tissue, one or two spherical lesions covering a
drawn share of it) and handed over as host arrays with their device copies
already uploaded, as the eval loader's pre-upload hands them. Its first half
is the val set and its second the test set. A pass is a val stage
(``orchestrate.run_stage`` over ``EvalSession``, groups of
``volumes_per_call`` volumes through ``VolumeReconstructor.batch_call_scored``
and committed on scorer threads), its ``test_end`` (which fits the
threshold), then a test stage with that threshold and its ``test_end``.
Passes repeat; once the window is due no new group starts, the stage in
flight drains and ends, and the window closes there.

For the check, a sample of the window's groups drawn from the seed keeps
what the timed path produced: each volume's reconstruction, its residual
and its packed scores; and one of the window's whole val stages, drawn from
the seed, keeps every volume's reconstruction and the threshold its
``test_end`` fitted (a window without a whole val stage runs one after it
closes)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..harness import flops
from ..harness.weights import make_weights


def make_subjects(n: int, shape, seed: int, share, lesions, device):
    """``n`` lesion subjects at ``shape`` [H, W, D]: host float32 arrays
    'vol' (= 'vol_orig'), 'mask_orig', 'seg_orig', and '_dev', their device
    copies."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w, d = shape
    ii, jj, kk = torch.meshgrid(*(torch.arange(s, dtype=torch.float32, device=device)
                                  for s in shape), indexing="ij")
    brain = (((ii - (h - 1) / 2) / (0.42 * h)) ** 2 + ((jj - (w - 1) / 2) / (0.36 * w)) ** 2
             + ((kk - (d - 1) / 2) / (0.45 * d)) ** 2) <= 1.0
    n_brain = float(brain.sum())
    tissue = torch.nn.functional.avg_pool3d(
        torch.rand((n, 1, h, w, d), generator=g, device=device), 3, 1, 1,
        count_include_pad=False)[:, 0]
    bright = 0.85 + 0.15 * torch.rand((n, h, w, d), generator=g, device=device)
    u = torch.rand((n, 8), generator=g, device=device).tolist()
    subs = []
    for i in range(n):
        count = lesions[0] + int(u[i][0] * (lesions[1] - lesions[0] + 1))
        total = share[0] + (share[1] - share[0]) * u[i][1]
        r = (3.0 * total * n_brain / count / (4.0 * math.pi)) ** (1.0 / 3.0)
        seg = torch.zeros(shape, dtype=torch.bool, device=device)
        for j in range(count):
            c = [s * (0.35 + 0.3 * u[i][2 + 3 * j + a]) for a, s in enumerate(shape)]
            seg |= ((ii - c[0]) ** 2 + (jj - c[1]) ** 2 + (kk - c[2]) ** 2) <= r * r
        seg &= brain
        vol = torch.where(seg, bright[i], brain * (0.2 + tissue[i]))
        dev = {"vol": vol, "vol_orig": vol, "mask_orig": brain.float(), "seg_orig": seg.float()}
        host = {k: v.cpu().numpy() for k, v in dev.items() if k != "vol_orig"}
        subs.append({"vol": host["vol"], "vol_orig": host["vol"], "mask_orig": host["mask_orig"],
                     "seg_orig": host["seg_orig"], "ID": f"s{i}", "label": 1, "_dev": dev})
    return subs


class EvalProtocol:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.p = cell.params
        self.model_cfg = cell.config["model"]

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from conditioned_diffusion_models_uad_torch.eval import reconstruct as R
        from conditioned_diffusion_models_uad_torch.eval.harness import EvalConfig
        from conditioned_diffusion_models_uad_torch.eval.reconstruct import VolumeReconstructor
        from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask
        from conditioned_diffusion_models_uad_torch.orchestrate import eval_key

        self.task = DDPMTask(self.cell.task_config(), device=self.device)
        self.task.load_state_dict(make_weights(self.task.state_dict(), self.cell.weight_seed(
            self.seed), self.device))
        self.recon = VolumeReconstructor(self.task, device=self.device)
        self.cfg = EvalConfig(volumes_per_call=self.p["volumes_per_call"],
                              scorer_threads=self.p["scorer_threads"],
                              cc_backend=self.p["cc_backend"],
                              hausdorff_backend=self.p["hausdorff_backend"])
        self.key = eval_key(self.cell.stage_key_seed(self.seed), 0)
        self.shape = tuple(self.cell.config["shape"])
        pool = make_subjects(self.p["subjects"], self.shape, self.cell.input_seed(self.seed),
                             self.p["lesion_share"], self.p["lesions"], self.device)
        half = len(pool) // 2
        self.stages = [("Brats21", "val", pool[:half]), ("Brats21", "test", pool[half:])]
        self.phases = {"load": 0.0, "recon": 0.0, "wait": 0.0, "total": 0.0}
        self._install_capture(R)
        group = self.p["volumes_per_call"]
        self.run(limit=group)  # warm-up: a val and a test stage of one group each
        self.phases = {k: 0.0 for k in self.phases}

    def _install_capture(self, R) -> None:
        """Keep, for a reservoir sample of the window's groups drawn from the
        seed, the group's subjects, draws and outputs as produced."""
        self.capturing = False
        self.sample, self.groups_seen = [], 0
        self._rng = np.random.default_rng(self.cell.check_seed(self.seed))
        self.val_kept, self.val_seen, self._val_groups = None, 0, []
        self._val_rng = np.random.default_rng(self.cell.derive(self.seed, "val_stage"))
        self._pending = None
        core, call = R.group_eval_core, self.recon.batch_call_scored

        def scored(subs, flags, seeds=None, **kw):
            if self.capturing:
                self._pending = {"ids": [s["ID"] for s in subs], "flags": flags,
                                 "stage": self._stage, "handed": self._handed}
            return call(subs, flags, seeds, **kw)

        def core_kept(orig, reco, mask, seg, *args, **statics):
            diff, packed = core(orig, reco, mask, seg, *args, **statics)
            if self.capturing and self._pending is not None:
                item = dict(self._pending, reco=reco, diff=diff, packed=packed)
                self._pending = None
                if item["stage"] == "val":
                    self._val_groups.append(item)
                k = self.groups_seen
                self.groups_seen += 1
                if k < self.p["check_groups"]:
                    self.sample.append(item)
                else:
                    j = int(self._rng.integers(0, k + 1))
                    if j < self.p["check_groups"]:
                        self.sample[j] = item
            return diff, packed

        self.recon.batch_call_scored = scored
        R.group_eval_core = core_kept
        self._restore = (R, core)

    # --------------------------------------------------------------- traffic
    def run(self, window=None, limit: int = 0, only: str = None) -> int:
        """Passes over the stages until the window is due (or, with
        ``limit``, one pass of ``limit`` volumes a stage; ``only``: that
        stage alone). Returns the volumes committed; with a window, marks
        its completion."""
        from conditioned_diffusion_models_uad_torch.eval.harness import EvalSession
        from conditioned_diffusion_models_uad_torch.orchestrate import run_stage

        group = self.p["volumes_per_call"]
        done = 0
        while True:
            threshold = None
            for dataset, stage, subs in self.stages:
                if only and stage != only:
                    continue

                def feed(subs=subs):
                    for i, sub in enumerate(subs[:limit] if limit else subs):
                        if window is not None and i and i % group == 0 and window.due():
                            return
                        yield sub

                session = EvalSession(self.cfg, dataset, stage, device=self.device,
                                      threshold=threshold if stage == "test" else None)
                self._stage, self._val_groups = stage, []
                self._handed = threshold["total"] if stage == "test" else math.nan
                ph = run_stage(session, self.recon, feed(), self.key,
                               volumes_per_call=group, scorer_threads=self.cfg.scorer_threads,
                               fused_dispatch=True, score_fn=self.task.anomaly_scores)
                session.test_end()
                if stage == "val":
                    threshold = dict(session.threshold)
                    if self.capturing and ph["volumes"] == len(subs):
                        self._keep_val(subs, threshold["total"])
                for k in self.phases:
                    self.phases[k] += ph[k]
                done += ph["volumes"]
                if window is not None:
                    window.mark(ph["volumes"])
                    if window.due():
                        return done
            if window is None:
                return done

    def _keep_val(self, subs, threshold: float) -> None:
        """A reservoir of one over the whole val stages seen."""
        self.val_seen += 1
        if int(self._val_rng.integers(0, self.val_seen)) == 0:
            self.val_kept = {"subs": subs, "threshold": threshold,
                             "groups": self._val_groups}

    def run_window(self, window) -> None:
        self.capturing = True
        window.open()
        self.run(window)
        if self.val_kept is None:  # no whole val stage in the window
            self.run(only="val")
        self.capturing = False

    def traced_slice(self) -> int:
        return self.run(limit=self.p["traced_volumes"])

    def install_spans(self) -> None:
        from conditioned_diffusion_models_uad_torch.eval import reconstruct as R
        from conditioned_diffusion_models_uad_torch.models.unet import AttentionBlock, GroupNorm32

        from ..harness import spans

        spans.wrap(self.recon, "_reconstruct", "uadbench.recon")
        spans.wrap(R, "group_eval_core", "uadbench.score")
        spans.hook_modules(self.task.unet, GroupNorm32, "uadbench.norm")
        spans.hook_modules(self.task.unet, AttentionBlock, "uadbench.attn")

    # --------------------------------------------------------------- metrics
    def padded_depth(self) -> int:
        d = self.shape[2]
        return -(-d // self.recon.depth_multiple) * self.recon.depth_multiple

    def end_to_end(self, window) -> dict:
        return {"scored_volumes_per_s": window.rate()}

    def attempted(self, window) -> int:
        return window.units

    def work_flops(self, volumes: int) -> float:
        return volumes * flops.eval_volume_flops(self.model_cfg, self.shape[:2],
                                                 self.padded_depth())

    def attention_calls(self, volumes: int) -> list:
        """(rows, tokens, channels) of each attention block call for
        ``volumes`` volumes: one call a volume, the ensemble's rows."""
        mc, mults = self.model_cfg["unet_dim"], self.model_cfg["channel_mult"]
        down = 2 ** (len(mults) - 1)
        s = (self.shape[0] // down) * (self.shape[1] // down)
        rows = len(self.model_cfg["step_ensemble"]) * self.padded_depth()
        return [(rows, s, mc * mults[-1])] * volumes

    # ----------------------------------------------------------------- check
    def free(self) -> dict:
        """Drop the program's state; returns what the check reads: the kept
        sample ('samples') and val stage ('val')."""
        from ..harness.checks import parse_scores

        R, core = self._restore
        R.group_eval_core = core
        pool = {s["ID"]: s for _, _, subs in self.stages for s in subs}
        index = {stage: {s["ID"]: i for i, s in enumerate(subs)} for _, stage, subs in self.stages}
        out = []
        for item in self.sample:
            for j, sid in enumerate(item["ids"]):
                sub = pool[sid]
                out.append({
                    "vol": sub["_dev"]["vol"], "mask": sub["_dev"]["mask_orig"],
                    "seg": sub["_dev"]["seg_orig"], "stage_index": index[item["stage"]][sid],
                    "th_record": item["handed"], "reco": item["reco"][j],
                    "diff": item["diff"][j], "statics": item["flags"]["statics"],
                    "scores": parse_scores(item["packed"][j].cpu().numpy(), self.shape[2])})
        kept = self.val_kept
        recos = {sid: g["reco"][j] for g in kept["groups"] for j, sid in enumerate(g["ids"])}
        subs = kept["subs"]
        val = {"vol": [s["_dev"]["vol"] for s in subs],
               "mask": [s["_dev"]["mask_orig"] for s in subs],
               "seg": [s["_dev"]["seg_orig"] for s in subs],
               "reco": [recos[s["ID"]] for s in subs],
               "statics": kept["groups"][0]["flags"]["statics"],
               "threshold": kept["threshold"]}
        del self.task, self.recon, self.sample, self.val_kept
        return {"samples": out, "val": val}

    def check_numbers(self, samples) -> dict:
        from ..harness.checks import judge_eval

        return judge_eval(samples, self.cell, self.seed, self.device)
