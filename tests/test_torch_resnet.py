"""The port's frozen ResNet guides against the JAX package's, at depth 18.

fp32; tolerance 1e-4 relative to the guides' largest magnitude (convs of
up to 4608 terms, summed in other orders by the two libraries)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn.resnet import init_resnet_params as jax_init_resnet_params
from mtvaf_tpu.nn.resnet import resnet_stage_guides as jax_guides
from mtvaf_tpu_torch.core.convert import (params_from_jax,
                                          resnet_params_from_torchvision)
from mtvaf_tpu_torch.nn.resnet import resnet_stage_guides
from test_torch_gcn import one_torch_thread  # noqa: F401


def _jax_case():
    jparams = jax.tree.map(np.asarray,
                           jax_init_resnet_params(jax.random.PRNGKey(1), 18))
    # non-trivial frozen BN statistics, so the folding is exercised
    rng = np.random.RandomState(0)

    def perturb(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "bias", "mean", "var"}:
                c = tree["scale"].shape
                return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                        "bias": rng.randn(*c).astype(np.float32) * 0.1,
                        "mean": rng.randn(*c).astype(np.float32) * 0.1,
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            return {k: perturb(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        return tree

    jparams = perturb(jparams)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_guides(jax.tree.map(jnp.asarray, jparams),
                                     jnp.asarray(images), depth=18))
    return jparams, images, want


def _check(got, want):
    assert got.shape == want.shape == (2, 4, 960)
    np.testing.assert_allclose(got, want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)


def test_stage_guides_match_jax():
    jparams, images, want = _jax_case()
    got = resnet_stage_guides(params_from_jax(jparams),
                              torch.from_numpy(images), depth=18)
    _check(got.numpy(), want)


def torchvision_state_dict(jparams):
    """JAX-layout ResNet params → a torchvision-layout state dict."""
    sd = {}

    def conv(name, p):
        sd[name + ".weight"] = torch.from_numpy(
            p["kernel"].transpose(3, 2, 0, 1).copy())

    def bn(name, p):
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{name}.{theirs}"] = torch.from_numpy(np.array(p[ours]))

    conv("conv1", jparams["conv1"])
    bn("bn1", jparams["bn1"])
    for s, blocks in enumerate(jparams["stages"], start=1):
        for b, bp in enumerate(blocks):
            p = f"layer{s}.{b}"
            for i in (1, 2, 3):
                if f"conv{i}" in bp:
                    conv(f"{p}.conv{i}", bp[f"conv{i}"])
                    bn(f"{p}.bn{i}", bp[f"bn{i}"])
            if "downsample" in bp:
                conv(p + ".downsample.0", bp["downsample"]["conv"])
                bn(p + ".downsample.1", bp["downsample"]["bn"])
    return sd


def test_torchvision_state_dict_loads_to_the_same_guides():
    jparams, images, want = _jax_case()
    got = resnet_stage_guides(
        resnet_params_from_torchvision(torchvision_state_dict(jparams), 18),
        torch.from_numpy(images), depth=18)
    _check(got.numpy(), want)
