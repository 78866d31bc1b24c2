"""Syntactic probe loss of the CRF model.

Counterpart of ``mtvaf_tpu/nn/probe.py``:

* :func:`probe_depths`: squared L2 norm of each token after the rank-384
  projection (OneWordPSDProbe);
* :func:`construct_pseudo_labels`: the sort-and-quantise pseudo-depth
  labels, in the JAX package's closed form (a stable sort and one running
  minimum, no sequential loop);
* :func:`probe_loss`: MSE between depths and the (detached) labels;
* :func:`combine_loss`: ``loss + probe_loss·β·2^(−epoch)`` gated on
  probe_loss > 0.1, with the constant epoch the CRF model passes (30).
"""

from __future__ import annotations

import torch

from ..core.mesh import batch_rows, batch_sum


def probe_depths(params, hidden):
    """(B, S, H) → per-token depth ‖B·h‖² (B, S), in fp32."""
    transformed = hidden.float() @ params["proj"].float()
    return transformed.square().sum(dim=-1)


def construct_pseudo_labels(norms):
    """Per row, sorted ascending: the smallest norm gets label 1, the second
    2, and each later one keeps the previous label unless it is at least
    that label + 0.5.  With 1-based sorted position j and r_j =
    max(floor(n_j + 0.5), 2), the label is j + min over 2 <= i <= j of
    (v_i - i), v_2 = 2, v_i = r_i.  The sorts are stable (as ``jnp.argsort``),
    so tied norms get the JAX package's labels."""
    norms = norms.float()
    order = torch.argsort(norms, dim=1, stable=True)
    sorted_norms = norms.gather(1, order)
    pos = torch.arange(norms.shape[1], dtype=torch.float32,
                       device=norms.device)[None, :]          # 0-based j-1
    r = torch.clamp(torch.floor(sorted_norms + 0.5), min=2.0)
    v = torch.where(pos == 1.0, 2.0, r)
    w = torch.where(pos == 0.0, torch.inf, v - (pos + 1.0))
    labels = (pos + 1.0) + torch.cummin(w, dim=1).values
    sorted_labels = torch.where(pos == 0.0, 1.0, labels)
    inv = torch.argsort(order, dim=1, stable=True)
    return sorted_labels.gather(1, inv)


def probe_loss(params, hidden):
    """MSE between probe depths and their pseudo-labels (no gradient
    through the labels)."""
    norms = probe_depths(params, hidden)
    labels = construct_pseudo_labels(norms.detach())
    return (norms - labels).square().mean()


def combine_loss(loss, p_loss, beta: float, epoch_const: int):
    """loss + probe_loss·β·2^(−epoch) when probe_loss > 0.1, else loss.
    Inside a data-parallel train step the gate reads the global batch's
    probe loss (the mean of the ranks')."""
    factor = beta * (2.0 ** (-epoch_const))
    gate = batch_sum(p_loss.detach()) / batch_rows(1)
    return torch.where(gate > 0.1, loss + p_loss * factor, loss)
