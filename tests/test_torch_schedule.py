"""The port's diffusion schedule and forward-process helpers against the JAX
package, on the CPU. The tables are float64 numpy cast to float32 on both
sides, so they must be bitwise equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conditioned_diffusion_models_uad_torch.diffusion import gaussian as tg
from conditioned_diffusion_models_uad_torch.diffusion.schedule import (
    extract,
    make_schedule,
)
from conditioned_diffusion_models_uad_tpu.diffusion import gaussian as jg
from conditioned_diffusion_models_uad_tpu.diffusion.schedule import (
    make_schedule as jax_make_schedule,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("kind,steps,gamma", [
    ("cosine", 1000, 0.0), ("linear", 1000, 0.0), ("cosine", 20, 1.0),
])
def test_schedule_tables_bitwise(kind, steps, gamma):
    want = jax_make_schedule(steps, kind, gamma, 1.0)
    got = make_schedule(steps, kind, gamma, 1.0)
    for f in dataclasses.fields(want):
        a = np.asarray(getattr(want, f.name))
        b = getattr(got, f.name).numpy()
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert got.num_timesteps == steps


@pytest.mark.parametrize("objective", ["pred_x0", "pred_noise"])
def test_forward_process_matches_jax(objective):
    sched_j = jax_make_schedule(1000, "cosine")
    sched_t = make_schedule(1000, "cosine")
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 1, size=(4, 8, 8, 1)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    out = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 249, 499, 999], np.int32)

    def jmodel(x, tt, c):
        return jnp.asarray(out)

    def tmodel(x, tt, c):
        return torch.from_numpy(out)

    jcfg = jg.GaussianDiffusionConfig(objective=objective)
    tcfg = tg.GaussianDiffusionConfig(objective=objective)
    xs_j = jg.normalize_to_neg_one_to_one(jnp.asarray(x0))
    jl, jr = jg.diffusion_call(sched_j, jcfg, jmodel, jnp.asarray(x0),
                               key=jax.random.PRNGKey(0), t=jnp.asarray(t),
                               noise=jnp.asarray(noise), reduce=False)
    tl, tr = tg.diffusion_call(sched_t, tcfg, tmodel, torch.from_numpy(x0),
                               t=torch.from_numpy(t), cond=None,
                               noise=torch.from_numpy(noise), reduce=False)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6, rtol=1e-6)

    xt_j = jg.q_sample(sched_j, xs_j, jnp.asarray(t), jnp.asarray(noise))
    xt_t = tg.q_sample(sched_t, tg.normalize_to_neg_one_to_one(torch.from_numpy(x0)),
                       torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(xt_t.numpy(), np.asarray(xt_j), atol=1e-6, rtol=0)
    pn_j, px_j = jg.model_predictions(sched_j, jcfg, jmodel, xt_j, jnp.asarray(t),
                                      clip_x_start=True)
    pn_t, px_t = tg.model_predictions(sched_t, tcfg, tmodel, xt_t,
                                      torch.from_numpy(t).long(), clip_x_start=True)
    np.testing.assert_allclose(px_t.numpy(), np.asarray(px_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pn_t.numpy(), np.asarray(pn_j), atol=1e-4, rtol=1e-5)


def test_extract_and_fixed_t():
    sched = make_schedule(20, "cosine")
    t = torch.tensor([0, 5, 19])
    e = extract(sched.sqrt_alphas_cumprod, t, 4)
    assert e.shape == (3, 1, 1, 1)
    np.testing.assert_array_equal(e.flatten().numpy(),
                                  sched.sqrt_alphas_cumprod[t].numpy())
    x0 = torch.rand(3, 4, 4, 1)
    noise = torch.randn(3, 4, 4, 1)
    cfg = tg.GaussianDiffusionConfig()

    def model(x, tt, c):
        return torch.zeros_like(x)

    l_int, r_int = tg.diffusion_call(sched, cfg, model, x0, t=7, cond=None,
                                     noise=noise, reduce=False)
    l_vec, r_vec = tg.diffusion_call(sched, cfg, model, x0, t=torch.full((3,), 7),
                                     cond=None, noise=noise, reduce=False)
    assert torch.equal(l_int, l_vec) and torch.equal(r_int, r_vec)
