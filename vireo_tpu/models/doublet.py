"""Doublet detection: one batched E-step over an expanded donor space.

Re-implements the reference's doublet predictor
(/root/reference/vireoSNP/utils/vireo_doublet.py:11-136) as pure JAX:
the donor axis grows by the C(K,2) donor pairs and the genotype axis by
the C(G,2) genotype combinations; the assignment E-step then runs once
on the expanded tensors with the exact same fused contraction as the
core model.
"""

import dataclasses
import functools
import itertools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.math import normalize, softmax_from_loglik, digamma_triplet

__all__ = ["add_doublet_theta", "add_doublet_GT", "predict_doublet"]


def _pair_idx(n):
    return np.array(list(itertools.combinations(range(n), 2)), dtype=np.int32)


@jax.jit
def add_doublet_theta(beta_mu, beta_sum):
    """Doublet allelic-rate categories: mean of the pair's means and the
    geometric mean of concentrations (vireo_doublet.py:85-102)."""
    G = beta_mu.shape[1]
    gi = _pair_idx(G)
    mu_db = (beta_mu[:, gi[:, 0]] + beta_mu[:, gi[:, 1]]) / 2.0
    sum_db = jnp.sqrt(beta_sum[:, gi[:, 0]] * beta_sum[:, gi[:, 1]])
    return (jnp.concatenate([beta_mu, mu_db], axis=-1),
            jnp.concatenate([beta_sum, sum_db], axis=-1))


@jax.jit
def add_doublet_GT(GT_prob):
    """Expanded genotype tensor (n_var, K + C(K,2), G + C(G,2))
    (vireo_doublet.py:105-136).

    Jitted: eagerly, the ~12 tensor ops building the (V, K + C(K,2),
    G + C(G,2)) expansion would each dispatch separately."""
    V, K, G = GT_prob.shape
    gi = _pair_idx(G)
    si = _pair_idx(K)
    g1, g2 = gi[:, 0], gi[:, 1]
    s1, s2 = si[:, 0], si[:, 1]

    A = GT_prob[:, s1, :]        # (V, P, G)
    B = GT_prob[:, s2, :]
    same = A * B                 # shared-genotype categories
    cross = A[:, :, g1] * B[:, :, g2] + A[:, :, g2] * B[:, :, g1]
    GT_pairs = normalize(jnp.concatenate([same, cross], axis=2), axis=2)

    GT_singlet = jnp.concatenate(
        [GT_prob, jnp.zeros((V, K, len(gi)), GT_prob.dtype)], axis=2)
    return jnp.concatenate([GT_singlet, GT_pairs], axis=1)


def _doublet_weights(gt_both, beta_mu_both, beta_sum_both):
    """Fold the expanded genotype tensor and theta digammas into the
    two (n_var, K_expanded) weight matrices of the cell E-step."""
    d1, d2, ds = digamma_triplet(beta_mu_both * beta_sum_both,
                                 (1.0 - beta_mu_both) * beta_sum_both)
    Wa = jnp.sum(gt_both * d1[:, None, :], axis=-1)
    Wb = jnp.sum(gt_both * d2[:, None, :], axis=-1)
    Ws = jnp.sum(gt_both * ds[:, None, :], axis=-1)
    return Wa - Wb, Wb - Ws


@jax.jit
def doublet_loglik(counts, gt_both, beta_mu_both, beta_sum_both):
    """(n_cell, K + C(K,2)) assignment log-likelihood over the expanded
    space (vireo_doublet.py:52-62), fused as two weight matrices.

    Jitted: eagerly, the int8->bf16 operand cast inside cell_loglik
    materializes matrix-sized copies (2 x 6 GB at 30k x 100k) instead
    of fusing into the matmul read."""
    Wfa, Wfd = _doublet_weights(gt_both, beta_mu_both, beta_sum_both)
    return counts.cell_loglik(Wfa, Wfd)


@functools.partial(jax.jit, static_argnames=("n_donor",))
def _doublet_posterior(counts, gt_both, beta_mu_both, beta_sum_both,
                       log_prior_row, n_donor):
    """E-step posterior + doublet LLR entirely on device.

    The round-trip variant (fetch the (C, K_exp) loglik, push a
    (C, K_exp) log prior, fetch the softmax) moves ~220 MB over the
    host link at 100k cells; this fetches only the posterior once and
    the (C,) LLR. The singlet slice comes out of the same dispatch."""
    Wfa, Wfd = _doublet_weights(gt_both, beta_mu_both, beta_sum_both)
    logLik = counts.cell_loglik(Wfa, Wfd)
    post = softmax_from_loglik(logLik, log_prior_row[None, :])
    llr = (jnp.max(logLik[:, n_donor:], axis=1)
           - jnp.max(logLik[:, :n_donor], axis=1))
    return post, llr, post[:, :n_donor]


def predict_doublet(vobj, AD, DP=None, update_GT=True, update_ID=True,
                    doublet_rate_prior=None):
    """Predict doublets from a fitted model (vireo_doublet.py:11-82).

    `vobj` is a fitted `models.vireo.Vireo`; returns
    (prob_doublet, prob_singlet, logLik_ratio) and, like the reference,
    refreshes vobj's ID_prob/GT_prob in place when requested.
    """
    counts = vobj._as_counts(AD, DP)
    K = vobj.n_donor
    n_cell = counts.n_cell

    gt_both = add_doublet_GT(vobj.state.gt_prob)
    mu_both, sum_both = add_doublet_theta(vobj.state.beta_mu,
                                          vobj.state.beta_sum)
    n_pair = gt_both.shape[1] - K

    if doublet_rate_prior is None:
        doublet_rate_prior = min(0.5, n_cell / 100000)

    id_prior_np = np.exp(np.asarray(vobj.priors.id_log))

    device_post = None
    if id_prior_np.shape[0] == 1:
        # row-broadcast prior (the standard configuration): posterior
        # and LLR stay on device, same f64 log -> dtype cast as the
        # matrix path below (bit-identical results)
        prior_row = np.concatenate(
            [id_prior_np[0] * (1 - doublet_rate_prior),
             np.full(n_pair, doublet_rate_prior / n_pair)])
        post, llr, post_singlet = _doublet_posterior(
            counts, gt_both, mu_both, sum_both,
            jnp.asarray(np.log(prior_row), vobj.dtype), K)
        device_post = post_singlet
        from ..utils.fetch import host_fetch
        ID_prob_both = host_fetch(post)
        logLik_ratio = host_fetch(llr)
    else:
        id_prior = np.broadcast_to(id_prior_np, (n_cell, K))
        prior_both = np.concatenate(
            [id_prior * (1 - doublet_rate_prior),
             np.full((n_cell, n_pair), doublet_rate_prior / n_pair)],
            axis=1)
        logLik_ID = np.asarray(
            doublet_loglik(counts, gt_both, mu_both, sum_both))
        ID_prob_both = np.asarray(softmax_from_loglik(
            jnp.asarray(logLik_ID), jnp.asarray(np.log(prior_both),
                                                logLik_ID.dtype)))
        logLik_ratio = (logLik_ID[:, K:].max(axis=1)
                        - logLik_ID[:, :K].max(axis=1))

    if update_ID:
        if device_post is not None:
            # the device singlet slice from the posterior dispatch, in
            # place of re-uploading the host copy
            vobj.state = dataclasses.replace(vobj.state,
                                             id_prob=device_post)
        else:
            vobj.ID_prob = ID_prob_both[:, :K]
        if update_GT:
            vobj.update_GT_prob(counts, None)
    elif update_GT:
        print("For update_GT, please turn on update_ID.")

    return ID_prob_both[:, K:], ID_prob_both[:, :K], logLik_ratio
