"""Core Vireo model: coordinate-ascent VB as a pure-functional jitted EM.

Reproduces the probabilistic model and update equations of the
reference `Vireo` class (/root/reference/vireoSNP/utils/vireo_model.py)
with an accelerator-first design:

- state/priors are pytrees; one EM iteration is a pure function
  ``em_step(counts, state, priors, cfg, ...)``;
- the fit loop is a ``lax.while_loop`` with the reference's exact
  convergence predicate (vireo_model.py:251-276), jit-compiled once per
  (shape, config);
- the reference's ~6 sparse matmuls per iteration collapse into one
  variant-side and one cell-side fused contraction (see ops/counts.py);
- multiple random restarts are vmapped (see engine/wrap.py) instead of
  forked processes (vireo_wrap.py:74-83).

A thin OO wrapper ``Vireo`` mirrors the reference class API for
notebook users.
"""

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.math import (normalize, softmax_from_loglik, kl_categorical,
                        beta_entropy, digamma_triplet)

__all__ = ["VireoConfig", "VireoState", "VireoPriors", "FitResult",
           "em_step", "fit_vb", "run_em_iters", "init_state",
           "default_priors", "random_init_arrays", "warn_from_trace",
           "Vireo"]


def warn_from_trace(trace, n_iter, max_iter, min_iter, style="vireo"):
    """Replay the reference's runtime self-checks from a fit's ELBO
    trace: warn on any ELBO decrease > 1e-6 past min_iter and on hitting
    max_iter without convergence (vireo_model.py:265-272,
    bmm_model.py:190-199). The device loop stays warning-free; the trace
    it already returns carries enough to reproduce the exact host-side
    prints. Returns the number of decreasing iterations.
    """
    trace = np.asarray(trace)
    n_iter = int(n_iter)
    tol = 0.0 if style == "bulk" else 1e-6  # vireo_bulk.py:95-104
    n_decrease = 0
    for it in range(n_iter):
        if it > min_iter:
            if trace[it] < trace[it - 1] - tol:
                n_decrease += 1
                if style == "bmm":
                    print("Warning: ELBO decreases %.8f to %.8f!\n"
                          % (trace[it - 1], trace[it]))
                elif style == "bulk":
                    print("Warning: logLikelihood decreases!\n")
                else:
                    print("Warning: Lower bound decreases!\n")
            elif it == max_iter - 1:
                print("Warning: VB did not converge!\n")
    return n_decrease


@dataclasses.dataclass(frozen=True)
class VireoConfig:
    """Static model configuration (hashable; part of the jit cache key).

    Field semantics follow the reference constructor flags
    (vireo_model.py:27-68).
    """
    n_var: int
    n_cell: int
    n_donor: int
    n_GT: int = 3
    learn_GT: bool = True
    learn_theta: bool = True
    ASE_mode: bool = False
    fix_beta_sum: bool = False

    @property
    def theta_len(self):
        return self.n_var if self.ASE_mode else 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VireoState:
    """Variational posterior parameters (vireo_model.py:18-25)."""
    beta_mu: jax.Array    # (theta_len, n_GT)
    beta_sum: jax.Array   # (theta_len, n_GT)
    gt_prob: jax.Array    # (n_var, n_donor, n_GT)
    id_prob: jax.Array    # (n_cell, n_donor)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VireoPriors:
    """Prior hyper-parameters, log-space for categorical priors."""
    theta_s1: jax.Array   # (1 or theta_len, n_GT)
    theta_s2: jax.Array
    id_log: jax.Array     # (1 or n_cell, n_donor) log prior
    gt_log: jax.Array     # (1 or n_var, n_donor, n_GT) log prior


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FitResult:
    state: VireoState
    elbo_ref: jax.Array    # reference-compatible final ELBO (= ELBO_[-1])
    elbo_final: jax.Array  # ELBO of the last executed iteration
    n_iter: jax.Array
    elbo_trace: jax.Array  # (max_iter,), NaN beyond n_iter


def random_init_arrays(cfg, rng=None, dtype=np.float64):
    """Draw (ID_prob, GT_prob) inits in the reference's order/semantics.

    Matches vireo_model.py:95-104: ID_prob = normalize(rand(C, K)) drawn
    first, then GT_prob = normalize(rand(V, K, G)), from numpy's legacy
    global-compatible stream so seeded runs reproduce the reference.
    """
    if rng is None:
        rng = np.random
    id_prob = rng.rand(cfg.n_cell, cfg.n_donor)
    id_prob = id_prob / id_prob.sum(axis=1, keepdims=True)
    gt_prob = rng.rand(cfg.n_var, cfg.n_donor, cfg.n_GT)
    gt_prob = gt_prob / gt_prob.sum(axis=2, keepdims=True)
    return id_prob.astype(dtype), gt_prob.astype(dtype)


def init_state(cfg, beta_mu_init=None, beta_sum_init=None,
               ID_prob_init=None, GT_prob_init=None, rng=None,
               dtype=jnp.float32):
    """Build a VireoState with the reference's defaults
    (vireo_model.py:78-104). Random draws happen in the same order and
    only for the fields left unset, preserving seeded-stream parity.
    """
    if rng is None:
        rng = np.random
    L, G = cfg.theta_len, cfg.n_GT
    if beta_mu_init is None:
        beta_mu = np.ones((L, G)) * np.linspace(0.01, 0.99, G)[None, :]
    else:
        beta_mu = np.broadcast_to(np.asarray(beta_mu_init, np.float64),
                                  (L, G)).copy()
    if beta_sum_init is None:
        beta_sum = np.ones((L, G)) * 50.0
    else:
        beta_sum = np.broadcast_to(np.asarray(beta_sum_init, np.float64),
                                   (L, G)).copy()

    if ID_prob_init is None:
        ID_prob_init = rng.rand(cfg.n_cell, cfg.n_donor)
    ID_prob_init = np.asarray(ID_prob_init, np.float64)
    ID_prob_init = ID_prob_init / ID_prob_init.sum(1, keepdims=True)

    if GT_prob_init is None:
        GT_prob_init = rng.rand(cfg.n_var, cfg.n_donor, cfg.n_GT)
    GT_prob_init = np.asarray(GT_prob_init, np.float64)
    GT_prob_init = GT_prob_init / GT_prob_init.sum(-1, keepdims=True)

    return VireoState(
        beta_mu=jnp.asarray(beta_mu, dtype),
        beta_sum=jnp.asarray(beta_sum, dtype),
        gt_prob=jnp.asarray(GT_prob_init, dtype),
        id_prob=jnp.asarray(ID_prob_init, dtype),
    )


def default_priors(cfg, GT_prior=None, ID_prior=None, beta_mu_prior=None,
                   beta_sum_prior=None, min_GP=0.00001, dtype=jnp.float32):
    """Priors with the reference's defaults and GT clipping
    (vireo_model.py:107-137)."""
    G = cfg.n_GT
    if beta_mu_prior is None:
        beta_mu_prior = np.linspace(0.01, 0.99, G)[None, :]
    beta_mu_prior = np.asarray(beta_mu_prior, np.float64)
    if beta_sum_prior is None:
        beta_sum_prior = np.ones(beta_mu_prior.shape) * 50.0
    beta_sum_prior = np.asarray(beta_sum_prior, np.float64)

    theta_s1 = beta_mu_prior * beta_sum_prior
    theta_s2 = (1.0 - beta_mu_prior) * beta_sum_prior

    if ID_prior is None:
        id_prior = np.full((1, cfg.n_donor), 1.0 / cfg.n_donor)
    else:
        id_prior = np.asarray(ID_prior, np.float64)
        if id_prior.ndim == 1:
            id_prior = id_prior[None, :]

    if GT_prior is None:
        gt_prior = np.full((1, cfg.n_donor, G), 1.0 / G)
    else:
        gt_prior = np.asarray(GT_prior, np.float64).copy()
        if gt_prior.ndim == 2:
            gt_prior = gt_prior[None, :, :]
        gt_prior = np.clip(gt_prior, min_GP, 1.0 - min_GP)
        gt_prior = gt_prior / gt_prior.sum(axis=-1, keepdims=True)

    return VireoPriors(
        theta_s1=jnp.asarray(theta_s1, dtype),
        theta_s2=jnp.asarray(theta_s2, dtype),
        id_log=jnp.asarray(np.log(id_prior), dtype),
        gt_log=jnp.asarray(np.log(gt_prior), dtype),
    )


def _theta_suff(S, gt_prob, ase_mode):
    """sum over donors (and variants unless ASE) of S[v,k]*GT[v,k,g].

    S: (V, K); gt_prob: (V, K, G) -> (V, G) if ASE else (1, G).
    (vireo_model.py:176-181)
    """
    per_var = jnp.einsum("vk,vkg->vg", S, gt_prob)
    if ase_mode:
        return per_var
    return jnp.sum(per_var, axis=0, keepdims=True)


def updates_from_stats(S1, SS, state, priors, cfg, update_theta):
    """theta + GT coordinate updates given the sufficient statistics
    S1 = AD @ ID_prob, SS = DP @ ID_prob (vireo_model.py:165-219).

    Returns (beta_mu, beta_sum, gt_prob, (Wfold_a, Wfold_d),
    KL_GT + KL_theta) where the W matrices fold the reference's three
    transposed spMMs per genotype category into two:
    logLik_ID = AD.T @ Wfold_a + DP.T @ Wfold_d.
    """
    S2 = SS - S1

    # --- theta update (vireo_model.py:165-185)
    t1 = priors.theta_s1 + _theta_suff(S1, state.gt_prob, cfg.ASE_mode)
    t2 = priors.theta_s2 + _theta_suff(S2, state.gt_prob, cfg.ASE_mode)
    new_mu = t1 / (t1 + t2)
    new_sum = state.beta_sum if cfg.fix_beta_sum else (t1 + t2)
    do_theta = jnp.asarray(update_theta) & jnp.asarray(cfg.learn_theta)
    beta_mu = jnp.where(do_theta, new_mu, state.beta_mu)
    beta_sum = jnp.where(do_theta, new_sum, state.beta_sum)

    # --- digammas of the (possibly) fresh theta posterior
    d1, d2, ds = digamma_triplet(beta_mu * beta_sum,
                                 (1.0 - beta_mu) * beta_sum)  # (L, G)

    # --- GT update (vireo_model.py:204-219)
    if cfg.learn_GT:
        logLik_GT = (S1[:, :, None] * d1[:, None, :]
                     + S2[:, :, None] * d2[:, None, :]
                     - SS[:, :, None] * ds[:, None, :])
        gt_prob = softmax_from_loglik(logLik_GT, priors.gt_log, axis=-1)
    else:
        gt_prob = state.gt_prob

    Wa = jnp.sum(gt_prob * d1[:, None, :], axis=-1)   # (V, K)
    Wb = jnp.sum(gt_prob * d2[:, None, :], axis=-1)
    Ws = jnp.sum(gt_prob * ds[:, None, :], axis=-1)

    KL_GT = kl_categorical(gt_prob, priors.gt_log)
    s1 = beta_mu * beta_sum
    s2 = (1.0 - beta_mu) * beta_sum
    KL_theta = beta_entropy(s1, s2, priors.theta_s1, priors.theta_s2)

    return beta_mu, beta_sum, gt_prob, (Wa - Wb, Wb - Ws), KL_GT + KL_theta


def em_step(counts, state, priors, cfg, update_theta, axis_name=None):
    """One coordinate-ascent iteration; returns (state', loglik_id, elbo).

    Update order matches _fit_VB (vireo_model.py:257-264): theta (using
    previous GT/ID posteriors), then GT (with fresh digammas), then ID,
    then the ELBO on the refreshed posteriors. `update_theta` may be a
    traced bool (implements `delay_fit_theta`).

    When `axis_name` is set (shard_map over a cell-sharded mesh), the
    per-cell ELBO terms are psum'd over that axis; the sufficient
    statistics are already globally reduced by the Counts backend.
    """
    S1, SS = counts.suff_stats(state.id_prob)            # (V, K) each

    beta_mu, beta_sum, gt_prob, (Wfa, Wfd), kl_params = \
        updates_from_stats(S1, SS, state, priors, cfg, update_theta)

    # --- ID update (vireo_model.py:187-201)
    loglik_id = counts.cell_loglik(Wfa, Wfd)              # (C, K)
    id_prob = softmax_from_loglik(loglik_id, priors.id_log, axis=-1)

    # --- ELBO (vireo_model.py:222-248)
    LB_p = jnp.sum(loglik_id * id_prob)
    KL_ID = kl_categorical(id_prob, priors.id_log)
    cell_terms = LB_p - KL_ID
    if axis_name is not None:
        cell_terms = jax.lax.psum(cell_terms, axis_name)
    elbo = cell_terms - kl_params

    new_state = VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                           gt_prob=gt_prob, id_prob=id_prob)
    return new_state, loglik_id, elbo


# jitted em_step for the eager single-step refresh APIs: without jit,
# the int8->bf16 operand casts materialize matrix-sized copies at
# 100k-cell scale instead of fusing into the matmuls
_em_step_jit = partial(jax.jit, static_argnames=("cfg", "axis_name"))(
    em_step)


@partial(jax.jit, static_argnames=("cfg", "max_iter", "min_iter",
                                   "delay_fit_theta", "axis_name"))
def fit_vb(counts, state, priors, cfg, max_iter=200, min_iter=5,
           epsilon_conv=1e-2, delay_fit_theta=0, axis_name=None):
    """Run coordinate ascent to convergence (vireo_model.py:251-276).

    Convergence predicate replicates the reference exactly, including
    its quirk that the recorded final ELBO (`elbo_ref`, used for model
    selection across restarts) is the ELBO of the *second-to-last*
    executed iteration — `_fit_VB` returns `ELBO[:it]`.
    """
    dtype = state.id_prob.dtype
    eps = jnp.asarray(epsilon_conv, dtype)
    tiny = jnp.asarray(1e-6, dtype)
    neg_inf = jnp.asarray(-jnp.inf, dtype)

    def cond(carry):
        it, st, prev, curr, trace = carry
        ran_full = it >= max_iter
        # reference-breaks after its iteration (it-1):
        their_it = it - 1
        delta = curr - prev
        breaked = ((their_it > min_iter)
                   & (delta >= -tiny)
                   & (delta < eps))
        return ~(ran_full | breaked)

    def body(carry):
        it, st, prev, curr, trace = carry
        st2, _, elbo = em_step(counts, st, priors, cfg,
                               update_theta=(it >= delay_fit_theta),
                               axis_name=axis_name)
        trace = trace.at[it].set(elbo)
        return (it + 1, st2, curr, elbo, trace)

    trace0 = jnp.full((max_iter,), jnp.nan, dtype)
    carry0 = (jnp.asarray(0), state, neg_inf, neg_inf, trace0)
    it, st, prev, curr, trace = jax.lax.while_loop(cond, body, carry0)
    return FitResult(state=st, elbo_ref=prev, elbo_final=curr,
                     n_iter=it, elbo_trace=trace)


@partial(jax.jit, static_argnames=("cfg", "axis_name"))
def run_em_iters(counts, state, priors, cfg, n_iters, axis_name=None):
    """Run exactly `n_iters` EM iterations (no convergence check).

    Benchmark/throughput entry point: a fori_loop of em_step with all
    updates enabled and a *traced* trip count, so one compilation
    serves any n. Returns (state, last_elbo).
    """
    def body(i, carry):
        st, _ = carry
        st2, _, elbo = em_step(counts, st, priors, cfg, update_theta=True,
                               axis_name=axis_name)
        return (st2, elbo)

    dtype = state.id_prob.dtype
    return jax.lax.fori_loop(
        0, n_iters, body, (state, jnp.asarray(-jnp.inf, dtype)),
        unroll=1)


# backwards-compatible alias (the two entry points were merged)
run_em_iters_n = run_em_iters


class Vireo:
    """OO wrapper mirroring the reference `Vireo` class API
    (vireo_model.py:11-315) on top of the functional kernels.

    Holds numpy copies of posteriors; `fit` accepts numpy/scipy AD, DP.
    """

    def __init__(self, n_cell, n_var, n_donor, n_GT=3, learn_GT=True,
                 learn_theta=True, ASE_mode=False, fix_beta_sum=False,
                 beta_mu_init=None, beta_sum_init=None, ID_prob_init=None,
                 GT_prob_init=None, dtype=jnp.float32, rng=None,
                 state_init=None):
        """`state_init`: adopt an existing (device) VireoState verbatim
        instead of building one from host inits — no placeholder
        normalization or upload (the wrap's device-init path hands the
        warm winner straight to the refit this way)."""
        self.config = VireoConfig(
            n_var=n_var, n_cell=n_cell, n_donor=n_donor, n_GT=n_GT,
            learn_GT=learn_GT, learn_theta=learn_theta, ASE_mode=ASE_mode,
            fix_beta_sum=fix_beta_sum)
        self.dtype = dtype
        self._rng = rng
        self.ELBO_ = np.zeros(0)
        if state_init is not None:
            self.state = state_init
        else:
            self.set_initial(beta_mu_init, beta_sum_init, ID_prob_init,
                             GT_prob_init)
        self.set_prior()

    # -- reference-compatible property surface
    @property
    def n_var(self):
        return self.config.n_var

    @property
    def n_cell(self):
        return self.config.n_cell

    @property
    def n_donor(self):
        return self.config.n_donor

    @property
    def n_GT(self):
        return self.config.n_GT

    @property
    def beta_mu(self):
        return np.asarray(self.state.beta_mu)

    @property
    def beta_sum(self):
        return np.asarray(self.state.beta_sum)

    @property
    def ID_prob(self):
        from ..utils.fetch import host_fetch
        return host_fetch(self.state.id_prob)

    @ID_prob.setter
    def ID_prob(self, value):
        self.state = dataclasses.replace(
            self.state, id_prob=jnp.asarray(value, self.dtype))

    @property
    def GT_prob(self):
        from ..utils.fetch import host_fetch
        return host_fetch(self.state.gt_prob)

    @property
    def ID_prior(self):
        return np.exp(np.asarray(self.priors.id_log))

    @property
    def theta_s1(self):
        """Beta concentration-1 of theta posterior (vireo_model.py:139)."""
        return self.beta_mu * self.beta_sum

    @property
    def theta_s2(self):
        """Beta concentration-2 of theta posterior (vireo_model.py:144)."""
        return (1 - self.beta_mu) * self.beta_sum

    @property
    def ELBO_iters(self):
        """Alias some notebooks use for the ELBO trace."""
        return self.ELBO_

    def set_initial(self, beta_mu_init=None, beta_sum_init=None,
                    ID_prob_init=None, GT_prob_init=None):
        self.state = init_state(
            self.config, beta_mu_init, beta_sum_init, ID_prob_init,
            GT_prob_init, rng=self._rng, dtype=self.dtype)

    def set_prior(self, GT_prior=None, ID_prior=None, beta_mu_prior=None,
                  beta_sum_prior=None, min_GP=0.00001):
        self.priors = default_priors(
            self.config, GT_prior, ID_prior, beta_mu_prior,
            beta_sum_prior, min_GP, dtype=self.dtype)

    def _as_counts(self, AD, DP):
        from ..ops.counts import counts_from_scipy
        if hasattr(AD, "suff_stats"):  # already a device counts object
            return AD
        return counts_from_scipy(AD, DP, dtype=self.dtype)

    def fit(self, AD, DP=None, max_iter=200, min_iter=5, epsilon_conv=1e-2,
            delay_fit_theta=0, verbose=True, **kwargs):
        """Single coordinate-ascent fit (multi-init lives in
        engine.wrap.vireo_wrap, mirroring the reference split)."""
        counts = self._as_counts(AD, DP)
        res = fit_vb(counts, self.state, self.priors, self.config,
                     max_iter=max_iter, min_iter=min_iter,
                     epsilon_conv=epsilon_conv,
                     delay_fit_theta=delay_fit_theta)
        # keep the state on device (it may be sharded across a mesh —
        # possibly spanning processes); only the replicated scalars and
        # the ELBO trace come to host
        self.state = res.state
        n_it = int(jax.device_get(res.n_iter))
        elbo_trace = np.asarray(jax.device_get(res.elbo_trace))
        if verbose:
            warn_from_trace(elbo_trace, n_it, max_iter, min_iter)
        # reference keeps ELBO[:it] where it is the last executed index
        elbo_hist = elbo_trace[:max(n_it - 1, 0)]
        elbo_hist = elbo_hist + float(
            jax.device_get(counts.binom_coeff_sum()))
        self.ELBO_ = np.append(self.ELBO_, elbo_hist)
        return self

    def update_ID_prob(self, AD, DP):
        """One E-step refresh, for API parity (vireo_model.py:187-201)."""
        counts = self._as_counts(AD, DP)
        cfg_fixed = dataclasses.replace(self.config, learn_GT=False,
                                        learn_theta=False)
        st, loglik_id, _ = _em_step_jit(counts, self.state, self.priors,
                                        cfg_fixed, update_theta=False)
        self.state = st
        return np.asarray(loglik_id)

    def update_GT_prob(self, AD, DP):
        """One GT-step refresh keeping theta/ID (vireo_model.py:204-219)."""
        counts = self._as_counts(AD, DP)
        cfg = dataclasses.replace(self.config, learn_GT=True,
                                  learn_theta=False)
        keep_id = self.state.id_prob
        st, _, _ = _em_step_jit(counts, self.state, self.priors, cfg,
                                update_theta=False)
        self.state = dataclasses.replace(st, id_prob=keep_id)
