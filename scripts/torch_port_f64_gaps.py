#!/usr/bin/env python3
"""How far the JAX package's float32 results and the PyTorch port's lie
from the JAX functions evaluated in float64, at the inputs of
tests/test_torch_fused_train.py and tests/test_torch_mobile_train.py (CPU,
S1/C16, 64x64, batch 4).

    JAX_PLATFORMS=cpu python scripts/torch_port_f64_gaps.py

Prints, for the fused train forward (heatmaps, max |d|) and its grads, and
for the mobile model's grads (max |d| over the largest |g|): JAX float32
vs float64, port vs float64, port vs JAX float32. Those tests hold the
port against the float64 evaluation because of these numbers.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from single_person_pose_estimation_tpu import losses as jl  # noqa: E402
from single_person_pose_estimation_tpu.experimental.fused_train import (  # noqa: E402
    fused_train_apply as jax_fused,
)
from single_person_pose_estimation_tpu.models.hourglass import (  # noqa: E402
    create_hourglass_model,
)
from single_person_pose_estimation_tpu.ops.heatmap import (  # noqa: E402
    render_heatmaps_batch,
)
from single_person_pose_estimation_tpu_torch import losses as tl  # noqa: E402
from single_person_pose_estimation_tpu_torch.experimental.fused_train import (  # noqa: E402
    fused_train_apply,
)
from single_person_pose_estimation_tpu_torch.utils.weight_convert import (  # noqa: E402
    to_state_dict,
)
from test_torch_fused_train import B, LABEL, _batch, _targets  # noqa: E402
from torch_port_fixtures import images, random_variables, torch_model  # noqa: E402


def jax_grads(model, variables, x, y):
    def loss(params):
        o, _ = model.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           train=True, mutable=["batch_stats"])
        return jl.total_loss(jl.weighted_mse, y, o)

    g = jax.jit(jax.grad(loss))(variables["params"])
    return {k: t.double() for k, t in to_state_dict(
        {"params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                g)}).items()}


def port_grads(model, outs, y):
    tl.total_loss(tl.weighted_mse, torch.from_numpy(y), outs).backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def gap(a, b, gmax):
    return max((a[n] - b[n]).abs().max().item() for n in b) / gmax


def fused_case(dt):
    v = random_variables(1, 16)
    variables = jax.tree.map(lambda a: jnp.asarray(a, dt), v)
    x, y = jnp.asarray(images(B), dt), jnp.asarray(_targets(), dt)
    outs, _ = jax_fused(variables, x, num_stacks=1, compute_dtype=dt,
                        kernel_backend="jnp")
    g = jax_grads(create_hourglass_model(17, 1, 16, compute_dtype=dt),
                  variables, x, y)
    return np.asarray(outs[0], np.float64), g


def mobile_case(dt):
    v = random_variables(1, 16, mobile=True)
    b = _batch()
    y = render_heatmaps_batch(*(jnp.asarray(b[k]) for k in ("kx", "ky",
                                                            "kv")),
                              height=LABEL, width=LABEL, sigma=1.0)
    g = jax_grads(create_hourglass_model(17, 1, 16, mobile=True,
                                         compute_dtype=dt),
                  jax.tree.map(lambda a: jnp.asarray(a, dt), v),
                  jnp.asarray(b["image"], dt), jnp.asarray(y, dt))
    return np.asarray(y, np.float32), g


def main():
    o32, g32 = fused_case(jnp.float32)
    y_mob, m32 = mobile_case(jnp.float32)
    with jax.enable_x64(True):
        o64, g64 = fused_case(jnp.float64)
        _, m64 = mobile_case(jnp.float64)
    model = torch_model(random_variables(1, 16), 1, 16)
    outs = fused_train_apply(model, torch.from_numpy(images(B)), "plain")
    op = outs[0].detach().double().numpy()
    gp = port_grads(model, outs, _targets())
    gmax = max(t.abs().max().item() for t in g64.values())
    print(f"fused heatmaps: JAX f32 vs f64 {np.abs(o32 - o64).max():.3e}, "
          f"port vs f64 {np.abs(op - o64).max():.3e}, port vs JAX f32 "
          f"{np.abs(op - o32).max():.3e}")
    print(f"fused grads (of the largest |g|): JAX f32 vs f64 "
          f"{gap(g32, g64, gmax):.3e}, port vs f64 {gap(gp, g64, gmax):.3e},"
          f" port vs JAX f32 {gap(gp, g32, gmax):.3e}")
    mobile = torch_model(random_variables(1, 16, mobile=True), 1, 16,
                         mobile=True)
    mp = port_grads(mobile, mobile(torch.from_numpy(_batch()["image"]),
                                   train=True), y_mob)
    gmax = max(t.abs().max().item() for t in m64.values())
    print(f"mobile grads (of the largest |g|): JAX f32 vs f64 "
          f"{gap(m32, m64, gmax):.3e}, port vs f64 {gap(mp, m64, gmax):.3e},"
          f" port vs JAX f32 {gap(mp, m32, gmax):.3e}")


if __name__ == "__main__":
    main()
