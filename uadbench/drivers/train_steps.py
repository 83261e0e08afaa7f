"""Traffic driver ``train_steps``: the flagship train step, back to back,
through the system's own ``train/loop.py::train_step`` and Adam.

A resident training set (``train_volumes`` volumes of the configuration's
shape, made on the device from the seed, as ``Trainer.fit`` holds it) feeds
batches of slices in the order of a seeded permutation of all its rows, so
no row repeats before every row was seen. Each step's draws (t, the noise
seed, the intensity augmentation's gates and parameters) come from a device
generator seeded from the run's seed, as ``Trainer.fit`` draws them a step at
a time. Set-up takes the first three steps through the same call and feed;
the window continues from that state. Step times are the host's intervals
between successive returns of ``train_step``; the window ends with a
synchronise after the step that closes it.

For the check, set-up keeps its three steps' losses, first gradients and
changes; and at a window step drawn from the seed (one of the first
``check_window_steps``) the window keeps the state it reached (parameters,
running statistics, Adam's moments and step) and the same of the three
steps from there, device copies taken between steps. Where the window closes
first, those steps follow it on the same call and feed."""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..harness import flops
from ..harness.weights import make_weights

CHECK_STEPS = 3


def make_volumes(n: int, shape, seed: int, device) -> torch.Tensor:
    """[n, H, W, D] float32 in [0, 1.2]: an ellipsoid brain of smoothed
    tissue, chunked so that no call holds more than one chunk's draws."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w, d = shape
    ii, jj, kk = torch.meshgrid(*(torch.arange(s, dtype=torch.float32, device=device)
                                  for s in shape), indexing="ij")
    brain = (((ii - (h - 1) / 2) / (0.42 * h)) ** 2 + ((jj - (w - 1) / 2) / (0.36 * w)) ** 2
             + ((kk - (d - 1) / 2) / (0.45 * d)) ** 2) <= 1.0
    out = torch.empty((n, h, w, d), device=device)
    step = max(1, (1 << 27) // (h * w * d))
    for i in range(0, n, step):
        m = min(step, n - i)
        noise = torch.rand((m, 1, h, w, d), generator=g, device=device)
        out[i:i + m] = brain * (0.2 + torch.nn.functional.avg_pool3d(
            noise, 3, 1, 1, count_include_pad=False)[:, 0])
    return out


class Feed:
    """Batches of (volume index, slice index) from a seeded permutation of
    all rows, and each step's draws, from one device generator."""

    def __init__(self, n_vols: int, depth: int, batch: int, timesteps: int, seed: int, device):
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.n_vols, self.depth, self.batch = n_vols, depth, batch
        self.timesteps, self.device = timesteps, device
        self.order, self.pos = None, 0

    def _rows(self):
        n = self.n_vols * self.depth
        if self.order is None or self.pos + self.batch > n:
            self.order = torch.randperm(n, generator=self.g, device=self.device)
            self.pos = 0
        rows = self.order[self.pos:self.pos + self.batch]
        self.pos += self.batch
        return rows // self.depth, rows % self.depth

    def next(self) -> dict:
        vi, si = self._rows()
        b, g, dev = self.batch, self.g, self.device

        def u(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

        def gate(p):
            return torch.rand((b,), generator=g, device=dev) < p

        return {
            "vi": vi, "si": si,
            "seed": torch.randint(0, 2**31 - 1, (1,), generator=g, dtype=torch.int32,
                                  device=dev),
            "t": torch.randint(0, self.timesteps, (b,), generator=g, device=dev),
            "aug": {"gamma_gate": gate(0.5), "log_gamma": u((b,), -0.3, 0.3),
                    "bias_gate": gate(0.25), "bias_coeffs": u((b, 10), -0.5, 0.5),
                    "blur_gate": gate(0.25), "blur_std": u((b,), 0.0, 2.0),
                    "ghost_gate": gate(0.5),
                    "ghost_num": torch.randint(4, 11, (b,), generator=g, device=dev),
                    "ghost_intensity": u((b,), 0.5, 1.0),
                    "ghost_along_h": torch.rand((b,), generator=g, device=dev) < 0.5},
        }


class TrainSteps:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.p = cell.params
        self.model_cfg = cell.config["model"]
        self.shape = tuple(cell.config["shape"])

    def feed(self) -> Feed:
        return Feed(self.p["train_volumes"], self.shape[2], self.p["batch"],
                    self.model_cfg["timesteps"], self.cell.check_seed(self.seed), self.device)

    def volumes(self) -> torch.Tensor:
        return make_volumes(self.p["train_volumes"], self.shape,
                            self.cell.input_seed(self.seed), self.device)

    def setup(self) -> None:
        from conditioned_diffusion_models_uad_torch.data.augment import AugDraws
        from conditioned_diffusion_models_uad_torch.models.tasks import DDPMTask, TrainDraws
        from conditioned_diffusion_models_uad_torch.train.loop import make_optimizer, train_step

        self.task = DDPMTask(self.cell.task_config(), device=self.device)
        self.task.load_state_dict(make_weights(self.task.state_dict(),
                                               self.cell.weight_seed(self.seed), self.device))
        self.opt = make_optimizer(self.task)
        self.data = (self.volumes(), None)
        self._feed = self.feed()

        def step():
            f = self._feed.next()
            draws = TrainDraws(f["t"], f["seed"], AugDraws(**f["aug"]))
            return train_step(self.task, self.opt, self.data, f["vi"], f["si"], draws)

        self.step = step
        self.steps_done, self.check_at, self.kept = 0, 1, None
        for _ in range(CHECK_STEPS):
            self._counted_step()
        self.setup_kept = self.kept
        rng = np.random.default_rng(self.cell.derive(self.seed, "window_step"))
        self.steps_done, self.kept = 0, None
        self.check_at = 1 + int(rng.integers(0, self.p["check_window_steps"]))
        gc.collect()
        gc.freeze()  # set-up's objects stay out of the window's collections

    def _floating(self) -> dict:
        return {k: v.detach().clone() for k, v in self.task.state_dict().items()
                if v.is_floating_point()}

    def _state(self) -> dict:
        """Device copies: the state ('state'), Adam's moments ('m', 'v';
        zeros where a leaf has none) and step count ('step')."""
        st = {n: (p, self.opt.state[p]) for n, p in self.task.named_parameters()}
        return {"state": {k: v.detach().clone() for k, v in self.task.state_dict().items()},
                "m": {n: s["exp_avg"].clone() if "exp_avg" in s else torch.zeros_like(p)
                      for n, (p, s) in st.items()},
                "v": {n: s["exp_avg_sq"].clone() if "exp_avg_sq" in s else torch.zeros_like(p)
                      for n, (p, s) in st.items()},
                "step": next((s["step"].clone() for _, s in st.values() if "step" in s), 0)}

    def _counted_step(self) -> None:
        """One step; from the ``check_at``-th on, three steps keep their
        copies in ``kept``: the state before them, their losses, Adam's
        first moment after the first, the floating state after the third."""
        self.steps_done += 1
        w = self.steps_done - self.check_at
        if w == 0:
            self._keeping = {"start": self._state(), "losses": []}
        loss = self.step()
        if 0 <= w < CHECK_STEPS:
            k = self._keeping
            k["losses"].append(loss)
            if w == 0:
                k["m1"] = {n: self.opt.state[p]["exp_avg"].clone()
                           if "exp_avg" in self.opt.state[p] else None
                           for n, p in self.task.named_parameters()}
            if w == CHECK_STEPS - 1:
                k["end"] = self._floating()
                self.kept = k

    @staticmethod
    def numbers(kept: dict) -> dict:
        """{'losses', 'grad_norms' (the first step's gradient by leaf, from
        Adam's first moment: (m1 - 0.9 m0) / 0.1; NaN where the step kept
        none), 'change_norms' (each floating leaf's change over the three
        steps)} of a ``kept`` record."""
        st, m0 = kept["start"]["state"], kept["start"]["m"]
        grads = {n: float("nan") if m is None else float(((m - 0.9 * m0[n]) / 0.1).norm())
                 for n, m in kept["m1"].items()}
        change = {k: float((v.float() - st[k].float()).norm()) for k, v in kept["end"].items()}
        return {"losses": torch.stack(kept["losses"]).tolist(), "grad_norms": grads,
                "change_norms": change}

    def run_window(self, window) -> None:
        window.open()
        while True:
            self._counted_step()
            if window.due():
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                window.mark(self.p["batch"])
                break
            window.mark(self.p["batch"])
        while self.kept is None:  # the window closed before the checked steps
            self._counted_step()

    def traced_slice(self) -> int:
        for _ in range(self.p["traced_steps"]):
            self.step()
        return self.p["traced_steps"] * self.p["batch"]

    def install_spans(self) -> None:
        from ..harness import spans

        spans.wrap(self.task, "loss", "uadbench.loss")
        spans.wrap(self.opt, "step", "uadbench.opt")

    def end_to_end(self, window) -> dict:
        return {"train_slices_per_s": window.rate(),
                "train_step_p90_ms": window.percentile_ms(90)}

    def attempted(self, window) -> int:
        return window.units // self.p["batch"]

    def work_flops(self, slices: int) -> float:
        return slices / self.p["batch"] * flops.train_step_flops(
            self.model_cfg, self.shape[:2], self.p["batch"])

    def free(self) -> dict:
        """Drop the program's state; returns the set-up steps' numbers, and
        under 'window' the checked window steps' numbers with the state
        they started from ('start', with 'skip': the feed's batches before
        them)."""
        win = self.numbers(self.kept)
        start = dict(self.kept["start"], skip=CHECK_STEPS + self.check_at - 1)
        start["step"] = int(start["step"])
        out = dict(self.numbers(self.setup_kept), window=dict(win, start=start))
        del self.task, self.opt, self.data, self._feed, self.step, self.kept, self.setup_kept
        self._keeping = None
        gc.unfreeze()
        return out

    def check_numbers(self, produced) -> dict:
        from ..harness.checks import judge_train

        return judge_train(produced, self, self.device)
