"""Linear-chain CRF: log-likelihood and Viterbi decoding.

Counterpart of ``mtvaf_tpu/nn/crf.py`` (the ``torchcrf.CRF`` semantics):
parameters ``start``/``end`` (N,) and ``transitions`` (N, N); the mask's
first step must be on and padding sits at the tail.  log Z is the forward
algorithm as the JAX package evaluates it, a log-semiring product of the
step matrices reduced as a binary tree, where a masked step is the
semiring identity (0 on the diagonal, NEG_INF = -1e30 off it: finite, so
no NaN reaches the gradient).  Decoding: argmax takes the first index on
ties; a masked step carries its score and an identity backpointer, so
positions past a sequence's length repeat its last tag; ``lengths`` is the
mask sum.  :func:`crf_decode` is the sequential Viterbi loop;
:func:`crf_decode_parallel` (``crf_decode_impl="parallel"``) gives the same
paths in O(log S) depth.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def crf_sequence_score(params, emissions, tags, mask):
    """Unnormalised score of the tag paths (B,) of (B, S, N) emissions."""
    emissions = emissions.float()
    maskf = mask.float()
    emit = emissions.gather(2, tags[..., None])[..., 0]
    emit_score = (emit * maskf).sum(dim=1)
    trans = params["transitions"][tags[:, :-1], tags[:, 1:]]   # (B, S-1)
    trans_score = (trans * maskf[:, 1:]).sum(dim=1)
    lengths = mask.long().sum(dim=1)
    last_tags = tags.gather(1, (lengths - 1)[:, None])[:, 0]
    return (params["start"][tags[:, 0]] + emit_score + trans_score
            + params["end"][last_tags])


def _step_matrices(params, emissions, maskf):
    """M_i[prev, next] = trans[prev, next] + e_i[next] on real steps, the
    semiring identity on masked ones: (B, S, N) → (B, S-1, N, N)."""
    n = emissions.shape[-1]
    mats = params["transitions"][None, None] + emissions[:, 1:, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=emissions.device)
    ident = torch.full((n, n), NEG_INF, device=emissions.device) \
        .masked_fill(eye, 0.0)
    return torch.where(maskf[:, 1:, None, None] > 0, mats, ident)


def _tree_reduce(mats):
    """Ordered log-semiring product of (B, T, N, N) matrices, as a binary
    tree (odd levels carry their last matrix through)."""
    while mats.shape[1] > 1:
        t = mats.shape[1]
        even, odd = mats[:, 0:t - (t % 2):2], mats[:, 1::2]
        reduced = torch.logsumexp(even[..., :, :, None]
                                  + odd[..., None, :, :], dim=-2)
        if t % 2:
            reduced = torch.cat([reduced, mats[:, -1:]], dim=1)
        mats = reduced
    return mats[:, 0]


def crf_log_normalizer(params, emissions, mask):
    """log Z (B,) of (B, S, N) emissions under a (B, S) mask."""
    emissions = emissions.float()
    alpha0 = params["start"][None, :] + emissions[:, 0]          # (B, N)
    if emissions.shape[1] == 1:
        return torch.logsumexp(alpha0 + params["end"][None, :], dim=1)
    final = _tree_reduce(_step_matrices(params, emissions, mask.float()))
    alpha = torch.logsumexp(alpha0[:, :, None] + final, dim=1)
    return torch.logsumexp(alpha + params["end"][None, :], dim=1)


def crf_log_likelihood(params, emissions, tags, mask,
                       reduction: str = "mean"):
    """Log-likelihood with the ``torchcrf`` reductions: none, sum, mean or
    token_mean."""
    llh = crf_sequence_score(params, emissions, tags, mask) \
        - crf_log_normalizer(params, emissions, mask)
    if reduction == "none":
        return llh
    if reduction == "sum":
        return llh.sum()
    if reduction == "mean":
        return llh.mean()
    if reduction == "token_mean":
        return llh.sum() / mask.float().sum().clamp(min=1.0)
    raise ValueError(f"unknown reduction {reduction!r}")


def crf_loss(params, emissions, tags, mask):
    """Training loss: minus the batch-mean log-likelihood."""
    return -crf_log_likelihood(params, emissions, tags, mask, "mean")


def crf_decode(params, emissions, mask):
    """Viterbi decode of (B, S, N) emissions under a (B, S) 0/1 mask.

    Returns (best_tags (B, S) int64, lengths (B,) int32)."""
    emissions = emissions.float()
    b, s, n = emissions.shape
    trans = params["transitions"].float()[None]                 # (1, N, N)
    on = (mask > 0)[:, :, None]                                 # (B, S, 1)
    ident = torch.arange(n, device=emissions.device).expand(b, n)

    score = params["start"].float()[None, :] + emissions[:, 0]
    bps = []
    for i in range(1, s):
        cand = score[:, :, None] + trans                        # (B, prev, next)
        best_prev = torch.argmax(cand, dim=1)
        new_score = torch.amax(cand, dim=1) + emissions[:, i]
        score = torch.where(on[:, i], new_score, score)
        bps.append(torch.where(on[:, i], best_prev, ident))
    score = score + params["end"].float()[None, :]

    tag = torch.argmax(score, dim=1)                            # (B,)
    tags = [tag]
    for bp in reversed(bps):
        tag = bp.gather(1, tag[:, None])[:, 0]
        tags.append(tag)
    lengths = mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return torch.stack(tags[::-1], dim=1), lengths


def _maxplus(a, b):
    """Max-plus product of (..., N, N) matrices: out[i, j] = max_k a[i, k]
    + b[k, j]."""
    return torch.amax(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def crf_decode_parallel(params, emissions, mask):
    """Viterbi decode in O(log S) depth, with :func:`crf_decode`'s
    semantics; the counterpart of the JAX package's
    ``crf_decode_parallel``.

    1. forward maxes: an inclusive max-plus prefix scan of the step
       matrices, ceil(log2(S-1)) rounds of batched products (each round
       combines every prefix with the one ``d`` steps before it, d = 1, 2,
       4, ...); a masked step is the semiring identity;
    2. backpointers: one argmax over the previous tag for every position;
    3. backtrace: pointer doubling, a reverse scan of backpointer-map
       composition ``(f o g)[t] = f[g[t]]`` by ``gather``.

    The scans are loops over their levels on whole tensors, so
    ``torch.export`` traces them into a short graph (a CRF text decode
    program at S=128: 1130 nodes, against 2663 with the sequential loop
    unrolled).  Its float sums run in another order
    than the sequential loop's, so paths whose scores tie within fp32
    rounding may break the tie otherwise.

    Returns (best_tags (B, S) int64, lengths (B,) int32)."""
    emissions = emissions.float()
    b, s, n = emissions.shape
    lengths = mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    alpha0 = params["start"].float()[None, :] + emissions[:, 0]    # (B, N)
    if s == 1:
        tag0 = torch.argmax(alpha0 + params["end"].float()[None, :], dim=1)
        return tag0[:, None], lengths

    mats = _step_matrices(params, emissions, mask.float())         # (B,S-1,N,N)
    prefix, d = mats, 1
    while d < s - 1:
        prefix = torch.cat([prefix[:, :d],
                            _maxplus(prefix[:, :-d], prefix[:, d:])], dim=1)
        d *= 2
    alphas = torch.amax(alpha0[:, None, :, None] + prefix, dim=2)  # (B,S-1,N)
    all_alphas = torch.cat([alpha0[:, None], alphas], dim=1)       # (B, S, N)

    # bps[:, i] maps the tag at position i+1 to the best tag at i
    bps = torch.argmax(all_alphas[:, :-1, :, None] + mats, dim=2)  # (B,S-1,N)

    # suffix[:, i] = bps[i] o bps[i+1] o ... o bps[S-2], built by doubling
    suffix, d = bps, 1
    while d < s - 1:
        suffix = torch.cat([suffix[:, :-d].gather(2, suffix[:, d:]),
                            suffix[:, -d:]], dim=1)
        d *= 2
    last_tag = torch.argmax(all_alphas[:, -1] + params["end"].float()[None, :],
                            dim=1)                                 # (B,)
    chains = suffix.gather(2, last_tag[:, None, None].expand(b, s - 1, 1))
    return torch.cat([chains[..., 0], last_tag[:, None]], dim=1), lengths
