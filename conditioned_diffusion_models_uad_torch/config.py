"""Typed config tree + YAML composition + CLI overrides (counterpart of
``conditioned_diffusion_models_uad_tpu/config.py``; it reads the same
``configs/`` tree and composes the same dict).

Reference: Hydra/OmegaConf, run.py:20-56, configs/config.yaml:12-39,
configs/experiment/cDDPM/*.yaml, with typed dataclasses in place of
scattered ``cfg.get(...)`` defaults:

* composition root `configs/config.yaml` with experiment overlays selected by
  ``experiment=cDDPM/<name>`` — same CLI shape as the reference
* dotted-key overrides ``a.b.c=value`` with YAML-typed values
* ``${env:VAR}`` / ``${env:VAR,default}`` interpolation (the reference's
  ``${oc.env:DATA_DIR}``, configs/config.yaml:37-39, fed by pc_environment.env)
* a `.env` file loader standing in for dotenv (run.py:16)

The composed dict is materialized into the typed configs consumed by each
subsystem: DDPMTaskConfig or, with ``task=Spark_2D``, SparkTaskConfig
(models), DataConfig (data), TrainerConfig (train), EvalConfig (eval). The
port's RunConfig adds one field, ``device`` (default ``cuda``; ``device=cpu``
asks for the CPU). Every experiment of ``configs/experiment/cDDPM`` and the
``model.reco_mode`` / ``model.sampling_steps`` / ``model.use_checkpoint``
overrides materialize as in the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Any, List, Optional, Sequence, Tuple

import yaml

from .data.datamodules import DataConfig
from .eval.harness import EvalConfig
from .models.tasks import DDPMTaskConfig, SparkTaskConfig
from .train.loop import TrainerConfig

_ENV_RE = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


def load_env_file(path: str = "environment.env") -> None:
    """KEY=VALUE lines -> os.environ (reference dotenv load, run.py:16)."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            os.environ.setdefault(k.strip(), v.strip().strip("'\""))


def _interp(value: Any) -> Any:
    if isinstance(value, str):
        def sub(m):
            var, default = m.group(1), m.group(2)
            if var in os.environ:
                return os.environ[var]
            if default is not None:
                return default
            raise KeyError(f"environment variable {var} is not set "
                           f"(required by config interpolation)")
        return _ENV_RE.sub(sub, value)
    return value


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_dotted(tree: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise TypeError(f"cannot override through non-dict at {k} in {dotted}")
    node[keys[-1]] = value


def _walk_interp(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _walk_interp(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk_interp(v) for v in node]
    return _interp(node)


_SCI_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _parse_value(v: str) -> Any:
    if v == "":
        return None
    # YAML 1.1 treats '1e-4' as a string (no dot before the exponent); coerce
    if _SCI_RE.match(v):
        return float(v)
    return yaml.safe_load(v)


def parse_overrides(args: Sequence[str]) -> dict:
    """['a.b=1', 'c=[1,2]'] -> nested dict with YAML-typed leaf values."""
    tree: dict = {}
    for a in args:
        if "=" not in a:
            raise ValueError(f"override '{a}' is not of the form key=value")
        k, v = a.split("=", 1)
        _set_dotted(tree, k, _parse_value(v))
    return tree


# Config groups (the reference Hydra tree's trainer/ model/ datamodule/
# callbacks/ logger/ mode/ directories, configs/config.yaml:12-31). The value
# is the config key a group file merges under; None merges at top level.
_GROUP_DIRS = {
    "trainer": "trainer",
    "model": "model",
    "datamodule": "datamodule",
    "eval": "eval",
    "callbacks": "callbacks",
    "logger": "logger",
    "mode": None,
}


def _parse_defaults(defaults) -> dict:
    """Hydra-style defaults list -> {group: name}. Accepts `- group: name`
    dict entries and `override group: name` keys; `name: null` deselects."""
    sel: dict = {}
    for item in defaults or []:
        if isinstance(item, dict):
            for g, n in item.items():
                g = str(g).removeprefix("override ").strip()
                if g not in _GROUP_DIRS:
                    raise KeyError(f"unknown config group '{g}' in defaults "
                                   f"(known: {sorted(_GROUP_DIRS)})")
                sel[g] = n
        elif item not in (None, "_self_"):
            raise ValueError(f"unsupported defaults entry: {item!r}")
    return sel


def _load_group(config_dir: str, group: str, name: str) -> dict:
    path = os.path.join(config_dir, group, f"{name}.yaml")
    with open(path) as f:
        content = yaml.safe_load(f) or {}
    key = _GROUP_DIRS[group]
    return content if key is None else {key: content}


def compose(
    config_dir: str,
    experiment: Optional[str] = None,
    overrides: Sequence[str] = (),
) -> dict:
    """Hydra-like composition: group defaults <- config.yaml <- experiment
    overlay <- CLI overrides. Bare `group=name` CLI keys (no dot) re-select a
    group file, mirroring Hydra's `trainer=fast` syntax."""
    with open(os.path.join(config_dir, "config.yaml")) as f:
        root = yaml.safe_load(f) or {}
    selections = _parse_defaults(root.pop("defaults", None))

    exp_tree: dict = {}
    if experiment:
        exp_path = os.path.join(config_dir, "experiment", experiment)
        if not exp_path.endswith(".yaml"):
            exp_path += ".yaml"
        with open(exp_path) as f:
            exp_tree = yaml.safe_load(f) or {}
        selections.update(_parse_defaults(exp_tree.pop("defaults", None)))

    dotted: List[str] = []
    for o in overrides:
        k, _, v = o.partition("=")
        if k in _GROUP_DIRS:
            # bare group=name re-selects a group file; a typo'd name must
            # fail HERE (falling through to the dotted path would set the
            # whole group subtree to a string and materialize would emit a
            # per-character unknown-keys error pointing nowhere useful)
            if os.path.exists(os.path.join(config_dir, k, f"{v}.yaml")):
                selections[k] = v
            else:
                gdir = os.path.join(config_dir, k)
                avail = sorted(
                    f[:-5] for f in os.listdir(gdir) if f.endswith(".yaml")
                ) if os.path.isdir(gdir) else []
                raise ValueError(
                    f"unknown option {v!r} for config group {k!r}; "
                    f"available: {avail}"
                )
        else:
            dotted.append(o)

    cfg: dict = {}
    for g, n in selections.items():
        if n is None:
            continue
        cfg = _deep_merge(cfg, _load_group(config_dir, g, str(n)))
    cfg = _deep_merge(cfg, root)
    if experiment:
        cfg = _deep_merge(cfg, exp_tree)
        cfg["experiment"] = experiment
    cfg = _deep_merge(cfg, parse_overrides(dotted))
    cfg["_overrides"] = list(overrides)  # for override-derived run-dir naming
    return _walk_interp(cfg)


# --------------------------------------------------------------------------- #
# materialization into typed configs
# --------------------------------------------------------------------------- #
def _filter_fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    out = {}
    for k, v in d.items():
        if isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return out


@dataclasses.dataclass
class CallbacksConfig:
    """Checkpoint-callback knobs (reference configs/callbacks/checkpoint.yaml).

    The reference always runs ModelCheckpoint(monitor='val/Loss_comb',
    save_top_k=1, save_last=True); best/last-per-fold is the only supported
    shape here too, so save_top_k is validated rather than generalized."""

    monitor: str = "val/loss_comb"
    save_top_k: int = 1
    save_last: bool = True

    def __post_init__(self):
        if self.save_top_k != 1:
            raise ValueError(
                "callbacks.checkpoint.save_top_k: only 1 is supported "
                "(best-by-val-loss + last, the reference's configuration)"
            )


@dataclasses.dataclass
class LoggerConfig:
    """Active loggers (reference configs/logger/*.yaml: wandb + csv)."""

    use_csv: bool = True
    use_wandb: bool = True
    project: Optional[str] = None  # default: uad_<datamodule>
    group: Optional[str] = None  # default: run name (ref src/train.py:59)


@dataclasses.dataclass
class RunConfig:
    """The composed run (reference configs/config.yaml top-level keys)."""

    name: str = "run"
    experiment: Optional[str] = None
    seed: int = 42
    debug: bool = False
    only_eval: bool = False
    resume_train: bool = False
    load_checkpoint: Optional[str] = None
    checkpoint: str = "best"  # 'best' | 'last' (ref configs/config.yaml:58)
    num_folds: int = 1
    start_fold: int = 0
    log_dir: str = "./logs"
    append_datetime: bool = False  # run-dir '<name>_<YYYY-MM-DD_HH-MM-SS>'
    # opt-in reference-style run-dir templating (configs/mode/default.yaml:8-36):
    # '<task>_<datamodule>_<name>_<override-dirname>[_<date>_<time>]', where
    # override-dirname joins the CLI overrides as 'key-value_key-value'
    run_dir_template: bool = False
    override_dirname: str = ""
    n_devices: Optional[int] = None
    task: str = "DDPM_2D"  # 'DDPM_2D' | 'Spark_2D'
    # the cDDPM's encoder backbone from a SparK run directory (this port's)
    # or a reference torch SparK .ckpt file, before the fit
    pretrained_encoder: Optional[str] = None
    device: str = "cuda"  # the port's entry points run here; 'cpu' asks for the CPU
    model: Any = None  # DDPMTaskConfig | SparkTaskConfig
    datamodule_name: str = "IXI"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    callbacks: CallbacksConfig = dataclasses.field(default_factory=CallbacksConfig)
    logger: LoggerConfig = dataclasses.field(default_factory=LoggerConfig)

    @property
    def run_dir(self) -> str:
        """Run directory (reference run-dir templating, configs/mode/
        default.yaml:8-36: '<name>_<date>' under LOG_DIR; the full
        override-derived job name when run_dir_template is on)."""
        name = self.name
        if self.run_dir_template:
            parts = [self.task, self.datamodule_name, self.name]
            if self.override_dirname:
                parts.append(self.override_dirname)
            name = "_".join(parts)
        if self.append_datetime:
            if not hasattr(self, "_stamp"):
                import datetime

                object.__setattr__(
                    self, "_stamp",
                    datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"),
                )
            name = f"{name}_{self._stamp}"
        return os.path.join(self.log_dir, name)


# CLI keys excluded from the override-derived run-dir name (reference
# configs/mode/default.yaml:22-29 exclude_keys, adapted to this config tree)
_OVERRIDE_DIRNAME_EXCLUDE = (
    "experiment", "load_checkpoint", "pretrained_encoder",
    "datamodule.sample_set", "datamodule.resized_evaluation", "n_devices",
    # infra/path knobs that must not leak into a directory name
    "log_dir", "run_dir_template", "append_datetime",
    # non-semantic group selections ('mode=reference' is the knob that turns
    # templating ON — embedding it would put a constant token in every name)
    "mode", "logger", "callbacks",
)


def _override_dirname(overrides: Sequence[str]) -> str:
    """'key-value_key-value' from the raw CLI overrides (reference
    hydra.job.override_dirname: item_sep '_', kv_sep '-')."""
    items = []
    for o in overrides:
        if "=" not in o:
            continue
        k, v = o.split("=", 1)
        if k in _OVERRIDE_DIRNAME_EXCLUDE or k == "name":
            continue
        items.append(f"{k}-{v}".replace(os.sep, "-"))
    return "_".join(items)


def materialize(tree: dict) -> RunConfig:
    """Composed dict -> RunConfig with typed sub-configs."""
    tree = copy.deepcopy(tree)
    raw_overrides = tree.pop("_overrides", [])
    task_name = tree.get("task", "DDPM_2D")
    model_d = tree.pop("model", {}) or {}
    data_d = tree.pop("datamodule", {}) or {}
    trainer_d = tree.pop("trainer", {}) or {}
    eval_d = tree.pop("eval", {}) or {}
    cb_d = tree.pop("callbacks", {}) or {}
    cb_d = cb_d.get("checkpoint", cb_d)  # accept {checkpoint: {...}} nesting
    logger_d = tree.pop("logger", {}) or {}

    dm_name = data_d.pop("name", "IXI")
    data_cfg = DataConfig(**_filter_fields(DataConfig, data_d))
    # the model operates at the datamodule's post-rescale resolution
    # (reference: image 96x96 = imageDim / rescaleFactor, DDPM_2D.py:37-60);
    # derive image_hw unless the experiment pins it explicitly
    model_d.setdefault("image_hw", list(data_cfg.model_hw))
    model_cls = SparkTaskConfig if task_name == "Spark_2D" else DDPMTaskConfig
    model = model_cls(**_filter_fields(model_cls, model_d))

    known = {f.name for f in dataclasses.fields(RunConfig)}
    top = {k: v for k, v in tree.items() if k in known and k not in
           ("model", "data", "trainer", "eval", "callbacks", "logger")}
    rc = RunConfig(
        **top,
        model=model,
        data=data_cfg,
        trainer=TrainerConfig(**_filter_fields(TrainerConfig, trainer_d)),
        eval=EvalConfig(**_filter_fields(EvalConfig, eval_d)),
        callbacks=CallbacksConfig(**_filter_fields(CallbacksConfig, cb_d)),
        logger=LoggerConfig(**_filter_fields(LoggerConfig, logger_d)),
    )
    rc.datamodule_name = dm_name
    rc.trainer.save_last = rc.callbacks.save_last
    if not rc.override_dirname:
        rc.override_dirname = _override_dirname(raw_overrides)

    # single-source knobs: the datamodule owns augmentation and the eval
    # resolution mode (the reference reads both from datamodule cfg)
    if "aug_intensity" not in trainer_d:
        rc.trainer.aug_intensity = rc.data.aug_intensity
    if "resized_evaluation" not in eval_d:
        rc.eval.resized_evaluation = rc.data.resized_evaluation

    # debug coercion (reference utils.extras, src/utils/utils.py:27-64)
    if rc.debug:
        rc.trainer.fast_dev_run = True
        rc.data.sample_set = True
    return rc


# group print order of the reference's rich dump (src/utils/utils.py:70-77);
# groups it doesn't name (task, eval, ...) are appended so nothing is hidden
_PRINT_FIELDS = ("trainer", "model", "datamodule", "callbacks", "logger", "seed")


def print_config(tree: dict, run_dir: Optional[str] = None) -> None:
    """Pretty-print the composed config tree at run start (the reference's
    rich tree dump, src/utils/utils.py:68-104): one branch per top-level
    group with YAML-highlighted content, mirrored to ``config_tree.txt`` in
    the run dir. Falls back to a plain YAML dump if rich is unavailable."""
    try:
        import rich.console
        import rich.syntax
        import rich.tree
    except Exception:
        print("── composed config " + "─" * 47)
        print(yaml.safe_dump(tree, sort_keys=False, default_flow_style=None).rstrip())
        print("─" * 66)
        return

    style = "dim"
    rtree = rich.tree.Tree("CONFIG", style=style, guide_style=style)
    fields = [f for f in _PRINT_FIELDS if f in tree]
    fields += [k for k in tree if k not in fields]
    for field in fields:
        branch = rtree.add(field, style=style, guide_style=style)
        section = tree[field]
        content = (
            yaml.safe_dump(section, sort_keys=False, default_flow_style=None)
            if isinstance(section, dict)
            else str(section)
        )
        branch.add(rich.syntax.Syntax(content.rstrip(), "yaml"))
    rich.console.Console().print(rtree)
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config_tree.txt"), "w") as fp:
            rich.console.Console(file=fp, force_terminal=False, width=120).print(rtree)


def save_config(tree: dict, path: str) -> None:
    """Persist the composed config (reference final_config.yaml, train.py:37-38)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(tree, f, sort_keys=False)
