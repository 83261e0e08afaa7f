"""utils/decisions.py: recording a run's piecewise choices (ReLU signs,
max-pool argmaxes, L1 error signs) and replaying them in another run."""
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.diffusion import gaussian
from conditioned_diffusion_models_uad_torch.models import resnet
from conditioned_diffusion_models_uad_torch.utils.decisions import recorded_choices
from conditioned_diffusion_models_uad_torch.utils.random_init import randomize_


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_replayed_relu_takes_the_recorded_mask_and_counts_flips():
    x = _x((2, 3, 4, 4))
    choices = []
    with recorded_choices(choices, replay=False):
        assert torch.equal(resnet.F.relu(x), torch.relu(x))
    y = x.clone().requires_grad_(True)
    with recorded_choices(choices, replay=True) as count:
        out = resnet.F.relu(-y)
    out.sum().backward()
    keep = x > 0
    assert count == {"made": x.numel(), "flipped": x.numel() - int((x == 0).sum())}
    assert torch.equal(out.detach(), -x * keep)
    assert torch.equal(y.grad, -keep.float())


def test_replayed_max_pool_gathers_the_recorded_indices():
    x = _x((2, 3, 6, 6), 1)
    choices = []
    with recorded_choices(choices, replay=False):
        torch.testing.assert_close(resnet.F.max_pool2d(x, 3, 2, 1),
                                   torch.nn.functional.max_pool2d(x, 3, 2, 1))
    z = _x((2, 3, 6, 6), 2)
    with recorded_choices(choices, replay=True) as count:
        got = resnet.F.max_pool2d(z, 3, 2, 1)
    idx = choices[0]
    want = z.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
    own = torch.nn.functional.max_pool2d(z, 3, 2, 1)
    assert torch.equal(got, want)
    assert count == {"made": idx.numel(), "flipped": int((want != own).sum())}
    with recorded_choices(choices, replay=True) as count:
        resnet.F.max_pool2d(x, 3, 2, 1)
    assert count["flipped"] == 0


def test_replayed_l1_takes_the_recorded_signs():
    a, b = _x((2, 8, 8, 1), 3), _x((2, 8, 8, 1), 4)
    choices = []
    with recorded_choices(choices, replay=False):
        assert torch.equal(gaussian.F.l1_loss(a, b, reduction="none"), (a - b).abs())
    y = b.clone().requires_grad_(True)
    with recorded_choices(choices, replay=True) as count:
        out = gaussian.F.l1_loss(a, y, reduction="none")
    out.sum().backward()
    assert count["flipped"] == 0 and count["made"] == a.numel()
    assert torch.equal(y.grad, -(a - b).sign())
    with recorded_choices([], replay=False, loss=False):
        assert gaussian.F is torch.nn.functional


def test_encoder_replay_on_its_own_input_is_exact_and_restores_functional():
    enc = randomize_(resnet.ResNetEncoder(resnet.ResNetConfig(variant="resnet18"),
                                          cond_dim=8), 1).train()
    x = torch.from_numpy(np.random.default_rng(5).uniform(size=(2, 32, 32, 1))
                         .astype(np.float32))
    choices = []
    with recorded_choices(choices, replay=False):
        want = enc(x)
    assert len(choices) == 2 + 2 * 8  # stem ReLU, max-pool, 2 ReLUs per block
    with recorded_choices(choices, replay=True) as count:
        got = enc(x)
    assert count["flipped"] == 0
    assert torch.equal(got, want)
    assert resnet.F is torch.nn.functional and gaussian.F is torch.nn.functional


def test_replay_needs_exactly_the_recorded_choices():
    x = _x((1, 2, 3, 3))
    choices = []
    with recorded_choices(choices, replay=False):
        resnet.F.relu(x)
    with pytest.raises(RuntimeError, match="only 1 choices"):
        with recorded_choices(choices, replay=True):
            resnet.F.relu(x)
            resnet.F.relu(x)
    with pytest.raises(RuntimeError, match="were not replayed"):
        with recorded_choices(choices + choices, replay=True):
            resnet.F.relu(x)
    with pytest.raises(RuntimeError, match="shape"):
        with recorded_choices(choices, replay=True):
            resnet.F.relu(x[:, :1])
