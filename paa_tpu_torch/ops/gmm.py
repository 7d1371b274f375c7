"""Batched 2-component 1-D Gaussian-mixture EM (port of
paa_tpu/ops/gmm.py).

Replaces the reference's per-GT ``sklearn.mixture.GaussianMixture(2)``
fit on host numpy (paa_core/modeling/rpn/paa/loss.py:190-203) with one
masked EM over a ``(..., K)`` tensor of candidate losses on the device,
with sklearn's semantics for this use: full covariance on 1-D data,
``reg_covar`` 1e-6, ``weights_init`` [.5, .5], ``means_init`` [min,
max], precisions 1.0; ``predict`` is the argmax responsibility,
``score_samples`` the logsumexp of the weighted component log-pdfs.

sklearn's convergence test (the mean log-likelihood moves by less than
``tol`` after an M-step) is kept per row: a row that converges freezes
its parameters for the rest of the ``num_iters`` iterations. Frozen rows
do not move, so once every row has converged the remaining iterations
change nothing: the loop reads that condition on the host every
``CHECK_EVERY`` iterations and stops there (one device sync per read),
with outputs identical to the full run. Masked-out entries have zero
responsibility and never affect the fit.
"""

from __future__ import annotations

import torch

_REG_COVAR = 1e-6
_LOG_2PI = 1.8378770664093453
# EM iterations between host-side reads of "every row converged". On an
# H100 80GB HBM3 (700 W) the PAA-R50 train step (B=16, 800 x 1344) took
# 237-292 ms with a read every 10 iterations and 271-350 ms with none:
# the EM is host-bound, and stopping early saves more launches than the
# syncs cost (PERF.md, the training findings)
CHECK_EVERY = 10


def _component_log_prob(x, means, variances, weights):
    """log w_k + log N(x | mu_k, var_k) for k = 0, 1.

    x: (..., K); means, variances, weights: (..., 2). Returns (..., K, 2).
    """
    diff = x[..., :, None] - means[..., None, :]
    var = variances[..., None, :]
    log_pdf = -0.5 * (diff * diff / var + torch.log(var) + _LOG_2PI)
    return log_pdf + torch.log(weights[..., None, :])


def gmm_fit_predict(values, valid, num_iters=100, tol=1e-3):
    """Fit a 2-component 1-D GMM to the valid entries of each row;
    classify and score every entry.

    values: (..., K) float; valid: (..., K) bool. Returns ``components``
    (..., K) int32 (0 = the low-mean, foreground component) and
    ``scores`` (..., K) float32 (sklearn ``score_samples``).
    """
    values = values.to(torch.float32)
    validf = valid.to(torch.float32)
    n_valid = validf.sum(dim=-1).clamp(min=1.0)

    big = torch.full((), 1e30, device=values.device)
    vmin = torch.where(valid, values, big).amin(dim=-1)
    vmax = torch.where(valid, values, -big).amax(dim=-1)
    # all-invalid rows fall back to [0, 1] inits (their outputs are unused)
    any_valid = valid.any(dim=-1)
    vmin = torch.where(any_valid, vmin, torch.zeros_like(vmin))
    vmax = torch.where(any_valid, vmax, torch.ones_like(vmax))

    means = torch.stack([vmin, vmax], dim=-1)
    variances = torch.ones_like(means)
    weights = torch.full_like(means, 0.5)
    prev_lb = torch.full(n_valid.shape, -float("inf"), device=values.device)
    converged = torch.zeros(n_valid.shape, dtype=torch.bool,
                            device=values.device)

    for it in range(num_iters):
        if it and it % CHECK_EVERY == 0 and bool(converged.all()):
            break
        # E step; also the pre-update mean log-likelihood, which sklearn
        # tests for convergence after the M step
        log_prob = _component_log_prob(values, means, variances, weights)
        lse = torch.logsumexp(log_prob, dim=-1)
        lb = (lse * validf).sum(dim=-1) / n_valid
        resp = torch.softmax(log_prob, dim=-1) * validf[..., :, None]
        # M step
        nk = resp.sum(dim=-2) + 1e-12
        new_means = (resp * values[..., :, None]).sum(dim=-2) / nk
        diff = values[..., :, None] - new_means[..., None, :]
        new_vars = (resp * diff * diff).sum(dim=-2) / nk + _REG_COVAR
        new_weights = nk / n_valid[..., None]
        upd = (~converged)[..., None]
        means = torch.where(upd, new_means, means)
        variances = torch.where(upd, new_vars, variances)
        weights = torch.where(upd, new_weights, weights)
        new_prev = torch.where(converged, prev_lb, lb)
        converged = converged | ((lb - prev_lb).abs() < tol)
        prev_lb = new_prev

    log_prob = _component_log_prob(values, means, variances, weights)
    components = log_prob.argmax(dim=-1).to(torch.int32)
    return components, torch.logsumexp(log_prob, dim=-1)
