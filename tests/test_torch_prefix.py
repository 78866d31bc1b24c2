"""The port's visual prefix generator and ANP loss against the JAX
package's.

fp32, JAX at "highest" precision; tolerance 1e-5 absolute (outputs O(1)),
1e-5 relative for the losses and their gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtvaf_tpu.nn.models import visual_prompt as jax_visual_prompt
from mtvaf_tpu.nn.prefix import anp_kl_loss as jax_anp_kl_loss
from mtvaf_tpu.nn.prefix import build_prefix_kvs as jax_build_prefix_kvs
from mtvaf_tpu.nn.prefix import init_prefix_params as jax_init_prefix_params
from mtvaf_tpu_torch.core.convert import params_from_jax
from mtvaf_tpu_torch.nn.prefix import anp_kl_loss, build_prefix_kvs
from test_torch_gcn import one_torch_thread  # noqa: F401

ATOL = 1e-5
L, H, DH, C = 3, 4, 8, 24


@pytest.mark.parametrize("with_aux", [False, True])
def test_build_prefix_kvs_matches_jax(with_aux):
    jparams = jax_init_prefix_params(
        jax.random.PRNGKey(0), in_channels=C, mid_dim=10,
        hidden_size=H * DH, num_layers=L, with_anp=True, num_anp_classes=7)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.RandomState(0)
    main = rng.randn(2, 4, C).astype(np.float32)
    aux = rng.randn(2, 3, 4, C).astype(np.float32) if with_aux else None
    with jax.default_matmul_precision("highest"):
        want_kvs, want_enc = jax_build_prefix_kvs(
            jparams, jnp.asarray(main),
            None if aux is None else jnp.asarray(aux),
            num_heads=H, head_dim=DH)
    kvs, enc, enc_aux = build_prefix_kvs(
        params, torch.from_numpy(main),
        None if aux is None else torch.from_numpy(aux),
        num_heads=H, head_dim=DH)
    assert kvs.shape == (L, 2, 2, H, 16 if with_aux else 4, DH)
    np.testing.assert_allclose(kvs.numpy(), np.asarray(want_kvs), atol=ATOL)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc), atol=ATOL)
    if with_aux:     # the aux encodings visual_prompt hands the ANP loss
        bert_cfg = type("B", (), {"num_attention_heads": H, "head_dim": DH})
        with jax.default_matmul_precision("highest"):
            _, _, want_aux = jax_visual_prompt(jparams, jnp.asarray(main),
                                               jnp.asarray(aux), bert_cfg)
        np.testing.assert_allclose(enc_aux.numpy(), np.asarray(want_aux),
                                   atol=ATOL)
    else:
        assert enc_aux is None


def test_head_regroup_is_raw_c_order_reshape():
    """(B, P, 768) → (B, 12, P, 64) is a plain reshape: head h holds the
    flat slice [h*P*Dh, (h+1)*P*Dh) of the (P, hidden) rows, not the
    per-token columns [h*Dh, (h+1)*Dh)."""
    jparams = jax_init_prefix_params(
        jax.random.PRNGKey(1), in_channels=C, mid_dim=10,
        hidden_size=H * DH, num_layers=L)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    main = torch.from_numpy(np.random.RandomState(2).randn(1, 4, C)
                            .astype(np.float32))
    kvs, enc, _ = build_prefix_kvs(params, main, None, num_heads=H,
                                   head_dim=DH)
    # rebuild the (L, P, hidden) key rows from the gates by hand
    from mtvaf_tpu_torch.nn.prefix import _gated_chunks
    rows = _gated_chunks(params, enc)[:, 0, :, :H * DH]         # (L, P, 768)
    flat = rows.reshape(L, -1)
    for h in range(H):
        torch.testing.assert_close(
            kvs[:, 0, 0, h].reshape(L, -1),
            flat[:, h * 4 * DH:(h + 1) * 4 * DH])
    per_token = rows.reshape(L, 4, H, DH).transpose(1, 2)
    assert not torch.allclose(kvs[:, 0, 0], per_token)


@pytest.mark.parametrize("with_aux", [False, True])
def test_anp_kl_loss_matches_jax(with_aux):
    """Zeros in the target exercise 0·log 0 = 0; gradients flow to the
    encodings and the classifiers."""
    n_cls = 7
    jparams = jax_init_prefix_params(
        jax.random.PRNGKey(3), in_channels=C, mid_dim=10,
        hidden_size=H * DH, num_layers=L, with_anp=True,
        num_anp_classes=n_cls)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.RandomState(4)
    enc = rng.randn(2, 4, 8 * H * DH).astype(np.float32)
    enc_aux = rng.randn(2, 3, 4, 8 * H * DH).astype(np.float32) \
        if with_aux else None
    label = rng.dirichlet(np.ones(n_cls), size=2).astype(np.float32)
    label[:, :3] = 0.0
    label /= label.sum(axis=1, keepdims=True)

    def jax_total(p, e):
        main, aux = jax_anp_kl_loss(
            p, e, None if enc_aux is None else jnp.asarray(enc_aux),
            jnp.asarray(label))
        return main + sum(aux), (main, aux)

    with jax.default_matmul_precision("highest"):
        (_, (want_main, want_aux)), (want_gp, want_ge) = jax.jit(
            jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True))(
                jparams, jnp.asarray(enc))
    te = torch.from_numpy(enc).requires_grad_()
    cls = params["img_classifier"]["kernel"].requires_grad_()
    main, aux = anp_kl_loss(
        params, te, None if enc_aux is None else torch.from_numpy(enc_aux),
        torch.from_numpy(label))
    (main + sum(aux)).backward()
    np.testing.assert_allclose(main.item(), float(want_main), rtol=1e-5)
    assert len(aux) == (3 if with_aux else 0)
    for got, want in zip(aux, want_aux):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(want_ge),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        cls.grad.numpy(), np.asarray(want_gp["img_classifier"]["kernel"]),
        rtol=1e-5, atol=1e-7)
