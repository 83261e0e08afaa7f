"""JAX-package variables -> this port's ``state_dict``.

Takes the JAX package's variables as nested dicts of numpy arrays and returns
``state_dict``s in the reference torch naming the port's modules use. It is
the exact inverse of the JAX package's ``convert_reference_unet_state_dict``
and ``convert_reference_resnet_state_dict`` (``utils/convert_torch.py``):

    conv2d  flax [kh, kw, I, O]  -> torch [O, I, kh, kw]
    dense   flax kernel [I, O]   -> torch [O, I]
    norms   flax scale/bias      -> torch weight/bias (+ running_mean/var)
    conv transpose flax [kh, kw, I, O] -> torch [I, O, kh, kw], flipped in
            kh and kw (flax's ConvTranspose does not flip its kernel)
    attention qkv flax Dense [C, 3C] (qkv-major) -> Conv1d [3C, C, 1]
            (head-major), proj_out Dense [C, C] -> Conv1d [C, C, 1]
    spatial transformer proj_in/proj_out Dense [C, C] -> Conv2d [C, C, 1, 1];
            ff_in/ff_out -> ff.net.0.proj/ff.net.2; LayerNorm scale -> weight

Every map is a linear re-indexing, so a tree shaped like the params
(gradients, Adam moments) converts the same way (``convert_jax_ddpm_params``,
``convert_jax_adam_state``, ``convert_jax_spark_variables``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

from ..models.resnet import _VARIANTS
from ..models.unet import UNetConfig, qkv_permutation


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd, key, p, bias=True):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if bias:
        sd[f"{key}.bias"] = _t(p["bias"])


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd, key, p, s=None):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    if s is not None:
        sd[f"{key}.running_mean"] = _t(s["mean"])
        sd[f"{key}.running_var"] = _t(s["var"])


def _gn(sd, key, p):
    sd[f"{key}.weight"] = _t(p["GroupNorm_0"]["scale"])
    sd[f"{key}.bias"] = _t(p["GroupNorm_0"]["bias"])


def convert_jax_unet_params(params: dict, cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """JAX ``UNetModel`` params (the tree under 'params') -> ``UNetModel``
    state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    mc = cfg.model_channels
    _dense(sd, "time_embed.0", params["time_dense1"])
    _dense(sd, "time_embed.2", params["time_dense2"])
    if cfg.cond_dim is not None:
        _dense(sd, "label_emb.0", params["label_dense1"])
        _dense(sd, "label_emb.2", params["label_dense2"])
    _conv(sd, "input_blocks.0.0", params["in_conv"])

    counters = {"res": 0, "attn": 0, "down": 0, "up": 0}

    def take(kind, name):
        """The next auto-numbered flax module of a kind: flax names them
        ``<Class>_<n>`` in call order."""
        p = params[f"{name}_{counters[kind]}"]
        counters[kind] += 1
        return p

    def put_res(prefix, in_ch, out_ch):
        p = params[f"res{counters['res']}"]
        counters["res"] += 1
        _gn(sd, f"{prefix}.in_layers.0", p["GroupNorm32_0"])
        _conv(sd, f"{prefix}.in_layers.2", p["in_conv"])
        _dense(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
        _gn(sd, f"{prefix}.out_layers.0", p["GroupNorm32_1"])
        _conv(sd, f"{prefix}.out_layers.3", p["out_conv"])
        if in_ch != out_ch:
            _conv(sd, f"{prefix}.skip_connection", p["skip"])

    def put_down(prefix, ch):
        if cfg.resblock_updown:
            put_res(prefix, ch, ch)
        elif cfg.conv_resample:
            _conv(sd, f"{prefix}.op", take("down", "Downsample")["Conv_0"])

    def put_up(prefix, ch):
        if cfg.resblock_updown:
            put_res(prefix, ch, ch)
        elif cfg.conv_resample:
            _conv(sd, f"{prefix}.conv", take("up", "Upsample")["Conv_0"])

    def put_1x1(key, p):
        sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None, None])
        sd[f"{key}.bias"] = _t(p["bias"])

    def put_transformer(prefix, p):
        _gn(sd, f"{prefix}.norm", p["GroupNorm32_0"])
        put_1x1(f"{prefix}.proj_in", p["proj_in"])
        put_1x1(f"{prefix}.proj_out", p["proj_out"])
        for i in range(cfg.transformer_depth):
            blk, key = p[f"block{i}"], f"{prefix}.transformer_blocks.{i}"
            for j in (1, 2, 3):
                _bn(sd, f"{key}.norm{j}", blk[f"norm{j}"])
            for a in ("attn1", "attn2"):
                for w in ("to_q", "to_k", "to_v"):
                    sd[f"{key}.{a}.{w}.weight"] = _t(np.asarray(blk[a][w]["kernel"]).T)
                _dense(sd, f"{key}.{a}.to_out.0", blk[a]["to_out"])
            _dense(sd, f"{key}.ff.net.0.proj", blk["ff_in"])
            _dense(sd, f"{key}.ff.net.2", blk["ff_out"])

    def put_attn(prefix, ch):
        if cfg.spatial_transformer:
            put_transformer(prefix, take("attn", "SpatialTransformer"))
            return
        p = take("attn", "AttentionBlock")
        heads = ch // cfg.num_head_channels if cfg.num_head_channels > 0 else cfg.num_heads
        perm = qkv_permutation(ch, heads)
        kernel = np.asarray(p["qkv"]["kernel"], np.float32)  # [C, 3C] qkv-major
        w = np.empty((3 * ch, ch), np.float32)
        w[perm] = kernel.T
        b = np.empty((3 * ch,), np.float32)
        b[perm] = np.asarray(p["qkv"]["bias"], np.float32)
        _gn(sd, f"{prefix}.norm", p["GroupNorm32_0"])
        sd[f"{prefix}.qkv.weight"] = _t(w[:, :, None])
        sd[f"{prefix}.qkv.bias"] = _t(b)
        sd[f"{prefix}.proj_out.weight"] = _t(np.asarray(p["proj_out"]["kernel"]).T[:, :, None])
        sd[f"{prefix}.proj_out.bias"] = _t(p["proj_out"]["bias"])

    ib, ch, ds = 1, mc, 1
    skip_chs = [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            put_res(f"input_blocks.{ib}.0", ch, mult * mc)
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                put_attn(f"input_blocks.{ib}.1", ch)
            skip_chs.append(ch)
            ib += 1
        if level != len(cfg.channel_mult) - 1:
            put_down(f"input_blocks.{ib}.0", ch)
            skip_chs.append(ch)
            ib += 1
            ds *= 2

    put_res("middle_block.0", ch, ch)
    put_attn("middle_block.1", ch)
    put_res("middle_block.2", ch, ch)

    ob = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            put_res(f"output_blocks.{ob}.0", ch + skip_chs.pop(), mult * mc)
            ch = mult * mc
            sub = 1
            if ds in cfg.attention_resolutions:
                put_attn(f"output_blocks.{ob}.{sub}", ch)
                sub += 1
            if level and i == cfg.num_res_blocks:
                put_up(f"output_blocks.{ob}.{sub}", ch)
                ds //= 2
            ob += 1

    _gn(sd, "out.0", params["GroupNorm32_0"])
    _conv(sd, "out.2", params["out_conv"])
    return sd


def convert_jax_resnet_variables(
    params: dict, batch_stats: Optional[dict], variant: str
) -> Dict[str, torch.Tensor]:
    """JAX ``ResNetEncoder`` params/batch_stats (the trees holding 'backbone'
    and, when present, 'fc') -> ``ResNetEncoder`` state_dict. With
    ``batch_stats=None`` only the parameters are converted."""
    block_cls, stage_sizes, _ = _VARIANTS[variant]
    n_convs = 3 if block_cls.expansion == 4 else 2
    bk = params["backbone"]
    bks = None if batch_stats is None else batch_stats["backbone"]
    sd: Dict[str, torch.Tensor] = {}
    put_bn = functools.partial(_bn, sd)

    def stats(name):
        return None if bks is None else bks[name]

    _conv(sd, "conv1", bk["stem_conv"], bias=False)
    put_bn("bn1", bk["stem_bn"], stats("stem_bn"))
    for si, n_blocks in enumerate(stage_sizes):
        for bi in range(n_blocks):
            t = f"layer{si + 1}.{bi}"
            name = f"stage{si + 1}_block{bi}"
            p, s = bk[name], stats(name)
            for j in range(1, n_convs + 1):
                _conv(sd, f"{t}.conv{j}", p[f"conv{j}"], bias=False)
                put_bn(f"{t}.bn{j}", p[f"bn{j}"], None if s is None else s[f"bn{j}"])
            if "down_conv" in p:
                _conv(sd, f"{t}.downsample.0", p["down_conv"], bias=False)
                put_bn(f"{t}.downsample.1", p["down_bn"],
                       None if s is None else s["down_bn"])
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
    return sd


def convert_jax_ddpm_variables(variables: dict, task_cfg) -> Dict[str, torch.Tensor]:
    """JAX ``DDPMTask`` variables ({'params': {'unet', 'encoder'},
    'batch_stats': {'encoder'}}) -> the port's ``DDPMTask`` state_dict."""
    return convert_jax_ddpm_params(variables["params"], task_cfg, variables["batch_stats"])


def convert_jax_ddpm_params(params: dict, task_cfg,
                            batch_stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX ``DDPMTask`` params ({'unet', 'encoder'}:
    the params, their gradients or an Adam moment) -> the port's parameter
    names (``DDPMTask.named_parameters``), plus the encoder's running
    statistics when ``batch_stats`` is given."""
    sd = {f"unet.{k}": v for k, v in
          convert_jax_unet_params(params["unet"], task_cfg.unet_config).items()}
    if task_cfg.condition:
        enc = convert_jax_resnet_variables(
            params["encoder"], None if batch_stats is None else batch_stats["encoder"],
            task_cfg.encoder_backbone,
        )
        sd.update({f"encoder.{k}": v for k, v in enc.items()})
    return sd


def convert_jax_spark_variables(params: dict, batch_stats: Optional[dict],
                                scfg) -> Dict[str, torch.Tensor]:
    """JAX ``SparKModel`` params/batch_stats (the trees under 'params' and
    'batch_stats'; gradients or AdamW moments in place of the params with
    ``batch_stats=None``) -> ``SparKModel`` state_dict (``SparkTask``'s keys
    without the ``model.`` prefix). ``scfg`` is the ``SparKConfig``."""
    bs = batch_stats or {}
    sd = {f"encoder.{k}": v for k, v in convert_jax_resnet_variables(
        {"backbone": params["encoder"]},
        None if batch_stats is None else {"backbone": bs["encoder"]}, scfg.backbone).items()}
    for i in range(scfg.pyramid):
        _bn(sd, f"densify_bn.{i}", params[f"densify_bn{i}"], bs.get(f"densify_bn{i}"))
        sd[f"mask_token.{i}"] = _t(np.asarray(params[f"mask_token{i}"]).transpose(0, 3, 1, 2))
        _conv(sd, f"densify_proj.{i}", params[f"densify_proj{i}"])
    dec, dec_bs = params["decoder"], bs.get("decoder", {})
    for i in range(5):
        p, s = dec[f"stage{i}"], dec_bs.get(f"stage{i}", {}).get("block", {})
        key = f"decoder.stages.{i}"
        kernel = np.asarray(p["up"]["kernel"])[::-1, ::-1]
        sd[f"{key}.up.weight"] = _t(kernel.transpose(2, 3, 0, 1))
        sd[f"{key}.up.bias"] = _t(p["up"]["bias"])
        for j in (1, 2):
            _conv(sd, f"{key}.block.conv{j}", p["block"][f"conv{j}"], bias=False)
            _bn(sd, f"{key}.block.bn{j}", p["block"][f"bn{j}"], s.get(f"bn{j}"))
    _conv(sd, "decoder.proj", dec["proj"])
    return sd


def convert_jax_adam_state(opt_state, task, optimizer: torch.optim.Optimizer) -> dict:
    """optax ``adam`` state (the chain's ``ScaleByAdamState`` with count, mu,
    nu; as host numpy trees) -> a ``state_dict`` for ``optimizer``, a
    ``torch.optim.Adam`` over ``task.parameters()`` (``train/loop.py::
    make_optimizer``), so the port continues a JAX run step for step."""
    states = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    adam = next(s for s in states if hasattr(s, "mu") and hasattr(s, "nu"))
    mu = convert_jax_ddpm_params(adam.mu, task.cfg)
    nu = convert_jax_ddpm_params(adam.nu, task.cfg)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    names = [n for n, _ in task.named_parameters()]
    state = {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
             for i, n in enumerate(names)}
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
