"""Jit-compatible math kernels shared by all vireo-tpu models.

Functional equivalents of the reference math library
(/root/reference/vireoSNP/utils/vireo_base.py:7-127): softmax helpers,
Beta-distribution KL in closed form, and log-binomial coefficients.
All functions are pure jnp and dtype-polymorphic; on the device they
run in float32 by default, while CPU verification tests may enable
float64.
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln


def betaln(a, b):
    """log Beta(a, b) via gammaln composition.

    jax.scipy.special.betaln deviates from scipy's by up to ~1e-6
    absolute in the concentration range this model lives in, while the
    gammaln composition agrees to ~2e-13 — enough to shift ELBO values
    (and, near the epsilon_conv threshold, the convergence iteration)
    away from the reference; see tests/test_math.py.
    """
    return gammaln(a) + gammaln(b) - gammaln(a + b)


def normalize(X, axis=-1):
    """Normalize a tensor so slices along `axis` sum to one.

    Matches the semantics of the reference `normalize`
    (vireo_base.py:44-56).
    """
    return X / jnp.sum(X, axis=axis, keepdims=True)


def loglik_amplify(X, axis=-1):
    """Subtract the max along `axis` for numerically stable exp.

    Matches the reference `loglik_amplify` (vireo_base.py:62-74).
    """
    return X - jnp.max(X, axis=axis, keepdims=True)


def softmax_from_loglik(logLik, log_prior, axis=-1):
    """Posterior = normalize(exp(amplify(logLik + log_prior))).

    The fused softmax used by every E-step in the reference
    (vireo_model.py:198-199, 218-219; bmm_model.py:153-154).
    """
    return normalize(jnp.exp(loglik_amplify(logLik + log_prior, axis=axis)),
                     axis=axis)


def kl_categorical(P, logP_prior, axis=-1):
    """sum_i P_i * (log P_i - log prior_i), summed over all slices.

    Equivalent to `scipy.stats.entropy(P, prior, axis)` summed, as used
    in the reference ELBO (vireo_model.py:237-238). Zero-probability
    entries contribute zero (xlogy convention).
    """
    safe_logP = jnp.log(jnp.where(P > 0, P, 1.0))
    return jnp.sum(jnp.where(P > 0, P * (safe_logP - logP_prior), 0.0))


def _beta_cross_entropy(p1, p2, q1, q2):
    """-E_p[log q] for Beta distributions (elementwise over arrays).

    Closed form mirrored from the reference `beta_entropy` inner helper
    (vireo_base.py:96-105).
    """
    return (betaln(q1, q2)
            - (q1 - 1.0) * digamma(p1)
            - (q2 - 1.0) * digamma(p2)
            + (q1 + q2 - 2.0) * digamma(p1 + p2))


def beta_entropy(s1, s2, s1_prior=None, s2_prior=None):
    """Sum of Beta entropies, or KL(post || prior) when priors given.

    Parameters are concentration arrays of any (broadcastable) shape;
    the result is summed over all elements, matching the reference
    `beta_entropy(..., axis=None)` (vireo_base.py:77-127).
    """
    if s1_prior is None:
        return jnp.sum(_beta_cross_entropy(s1, s2, s1, s2))
    return jnp.sum(_beta_cross_entropy(s1, s2, s1_prior, s2_prior)
                   - _beta_cross_entropy(s1, s2, s1, s2))


def log_binom_coeff(dp, ad, max_val=700.0):
    """log C(dp, ad) elementwise, 0 where dp == 0, clipped at `max_val`.

    Computed via gammaln (identical analytically to the reference's
    log(scipy.special.binom)), reproducing `get_binom_coeff`
    (vireo_base.py:7-22) including its 700 clip.
    """
    val = gammaln(dp + 1.0) - gammaln(ad + 1.0) - gammaln(dp - ad + 1.0)
    val = jnp.minimum(val, max_val)
    return jnp.where(dp > 0, val, 0.0)


def get_binom_coeff(AD, DP, max_val=700, is_log=True):
    """Sum-compatible API shim over `log_binom_coeff` for dense arrays.

    Returns the flat array of log binomial coefficients for entries with
    DP > 0, like the reference `get_binom_coeff` (vireo_base.py:7-22).
    """
    import numpy as np
    AD = np.asarray(AD, dtype=np.float64)
    DP = np.asarray(DP, dtype=np.float64)
    idx = DP > 0
    out = np.asarray(jax.device_get(
        log_binom_coeff(jnp.asarray(DP[idx]), jnp.asarray(AD[idx]),
                        max_val=float(max_val))))
    return out.astype(np.float32)


def digamma_triplet(s1, s2):
    """(digamma(s1), digamma(s2), digamma(s1+s2)) — the E[log theta]
    pieces used by every update (vireo_model.py:149-162)."""
    return digamma(s1), digamma(s2), digamma(s1 + s2)
