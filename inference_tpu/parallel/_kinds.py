"""Per-kind sampler kernel construction shared by the scale-out layer.

``ChainArray`` (vmapped independent chains) and ``ShardedTempering``
(replica exchange over a device mesh) both need, for a given sampler
family, a per-chain ``init`` and a compiled ``step`` — with every
constraint/mass option the single-chain facades support (reference:
inference/mcmc/gibbs.py:97-122 per-parameter non-negative and reflecting
proposals; inference/mcmc/hmc/mass.py:57-94 full matrix mass;
inference/mcmc/ensemble.py for the stretch move). This module builds them
once so the two scale-out classes stay feature-identical.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..mcmc._kernels import hmc as hmc_kernel
from ..mcmc._kernels import metropolis as met_kernel
from ..mcmc._kernels import ensemble as ens_kernel
from ..mcmc._kernels import nuts as nuts_kernel

KINDS = ("hmc", "nuts", "gibbs", "metropolis", "pca", "ensemble")


def build_proposal_modes(
    n_parameters, dtype, non_negative=None, boundaries=None
):
    """
    Per-parameter proposal behaviour masks for the Metropolis family
    (reference: gibbs.py:88-122 selects the proposal transform per
    parameter; here the selection is data, not control flow).

    :param non_negative: bool, or a (P,) boolean array — parameters whose
        proposals are folded to non-negative values with ``abs``.
    :param boundaries: optional ``(lower, upper)`` arrays giving reflecting
        boundaries applied to every parameter.
    """
    nn = np.zeros(n_parameters, bool)
    if non_negative is not None:
        nn[...] = np.asarray(non_negative, bool)
    bounded = np.zeros(n_parameters, bool)
    lower = np.zeros(n_parameters)
    upper = np.ones(n_parameters)
    if boundaries is not None:
        lo, up = boundaries
        lower[...] = np.asarray(lo, float)
        upper[...] = np.asarray(up, float)
        if (lower >= upper).any():
            raise ValueError(
                "[ boundaries error ] all upper bounds must exceed the "
                "corresponding lower bounds"
            )
        bounded[...] = True
    if (nn & bounded).any():
        raise ValueError(
            "a parameter cannot be both non-negative and reflecting-bounded"
        )
    return met_kernel.ProposalModes(
        non_negative=jnp.asarray(nn),
        bounded=jnp.asarray(bounded),
        lower=jnp.asarray(lower, dtype),
        upper=jnp.asarray(upper, dtype),
    )


def build_mass_maps(n_parameters, dtype, inverse_mass=None):
    """
    HMC inverse-mass application and momentum sampling for scalar, vector
    (diagonal) or full-matrix inverse mass (reference: hmc/mass.py:9-117).
    Momenta are drawn with covariance M = (M^-1)^-1: for a full matrix with
    Cholesky factor M^-1 = L L^T, ``r = L^-T z`` gives cov(r) = M.
    """
    if inverse_mass is None:
        return (
            lambda r: r,
            lambda k, d: jax.random.normal(k, (n_parameters,), d),
        )
    inv_mass = np.asarray(inverse_mass, dtype=float)
    if inv_mass.ndim <= 1:
        im = jnp.asarray(np.broadcast_to(inv_mass, (n_parameters,)), dtype)
        if (np.asarray(im) <= 0).any():
            raise ValueError("inverse mass values must all be positive")
        sqrt_mass = 1.0 / jnp.sqrt(im)
        return (
            lambda r: r * im.astype(r.dtype),
            lambda k, d: jax.random.normal(k, (n_parameters,), d)
            * sqrt_mass.astype(d),
        )
    if inv_mass.shape != (n_parameters, n_parameters):
        raise ValueError(
            f"matrix inverse mass must have shape "
            f"({n_parameters}, {n_parameters}), got {inv_mass.shape}"
        )
    chol = np.linalg.cholesky(inv_mass)  # raises if not positive-definite
    im = jnp.asarray(inv_mass, dtype)
    # momentum sampling is r = L^-T z; precompute the factor inverse ON
    # THE HOST (one P x P triangular solve at build time) so the
    # per-transition device op is a matmul — a vmapped triangular solve
    # over the chain batch is a sequential substitution, while the
    # (chains, P) x (P, P) product is one matrix multiply
    from scipy.linalg import solve_triangular as host_solve_triangular

    Linv_T = jnp.asarray(
        host_solve_triangular(chol, np.eye(n_parameters), lower=True).T,
        dtype,
    )

    def sample(k, d):
        z = jax.random.normal(k, (n_parameters,), d)
        return Linv_T.astype(d) @ z

    return (lambda r: im.astype(r.dtype) @ r, sample)


def build_kind(
    kind: str,
    logp_fn,
    n_parameters: int,
    dtype,
    *,
    widths=None,
    epsilon: float = 0.1,
    steps: int = 50,
    inverse_mass=None,
    non_negative=None,
    boundaries=None,
    bounds=None,
    alpha: float = 2.0,
    n_walkers: int = None,
    retry: bool = False,
    max_depth: int = 10,
):
    """
    Build ``(init, step)`` for one sampler family:

    - ``init(theta0, logp0, key, inv_temp)`` initialises one chain/lane's
      state (for "ensemble", ``theta0``/``logp0`` have a leading walker
      axis and the lane is a whole sub-ensemble);
    - ``step(state) -> (state, output)`` is the pure compiled transition,
      ready to be vmapped over lanes and rungs.

    :param bounds: optional ``utils.Bounds`` — reflecting boundaries for
        the hmc (bounded leapfrog) and ensemble (reflected stretch moves)
        kinds; the Metropolis family uses ``boundaries`` per-parameter
        reflecting proposals instead.
    """
    if kind == "hmc":
        mass_velocity, mass_sample = build_mass_maps(
            n_parameters, dtype, inverse_mass
        )
        step = hmc_kernel.make_hmc_step(
            logp_fn,
            jax.grad(logp_fn),
            mass_velocity=mass_velocity,
            mass_sample=mass_sample,
            bounds_reflect=(bounds.reflect_momenta if bounds is not None else None),
            retry=retry,
        )

        def init(theta0, logp0, key, inv_temp=1.0):
            return hmc_kernel.init_hmc_state(
                theta0, logp0, epsilon, key, inv_temp=inv_temp, steps=steps
            )

        return init, step

    if kind == "nuts":
        if bounds is not None:
            raise ValueError(
                "the nuts kind does not support reflecting bounds — "
                "reparameterise the posterior or use the hmc kind"
            )
        mass_velocity, mass_sample = build_mass_maps(
            n_parameters, dtype, inverse_mass
        )
        step = nuts_kernel.make_nuts_step(
            logp_fn,
            max_depth=max_depth,
            mass_velocity=mass_velocity,
            mass_sample=mass_sample,
        )

        def init(theta0, logp0, key, inv_temp=1.0):
            return nuts_kernel.init_nuts_state(
                theta0,
                logp0,
                epsilon,
                key,
                inv_temp=inv_temp,
                grad0=inv_temp * jax.grad(logp_fn)(jnp.asarray(theta0)),
            )

        return init, step

    if kind in ("gibbs", "metropolis"):
        modes = build_proposal_modes(
            n_parameters, dtype, non_negative, boundaries
        )
        factory = (
            met_kernel.make_gibbs_step
            if kind == "gibbs"
            else met_kernel.make_metropolis_step
        )
        step = factory(logp_fn, modes, retry=retry)
        w = widths if widths is not None else 1.0
        w_arr = jnp.asarray(np.broadcast_to(np.asarray(w, float), (n_parameters,)), dtype)

        def init(theta0, logp0, key, inv_temp=1.0):
            return met_kernel.init_metropolis_state(
                theta0, logp0, w_arr, key, inv_temp=inv_temp
            )

        return init, step

    if kind == "pca":
        step = met_kernel.make_pca_step(
            logp_fn,
            bounds_reflect=(bounds.reflect if bounds is not None else None),
            retry=retry,
        )
        w = widths if widths is not None else 1.0
        w_arr = jnp.asarray(np.broadcast_to(np.asarray(w, float), (n_parameters,)), dtype)
        eye = jnp.eye(n_parameters, dtype=dtype)

        def init(theta0, logp0, key, inv_temp=1.0):
            return met_kernel.init_pca_state(
                theta0, logp0, w_arr, key, eye, inv_temp=inv_temp
            )

        return init, step

    if kind == "ensemble":
        if n_walkers is None:
            raise ValueError("the ensemble kind requires n_walkers")
        if n_walkers < 2 * (n_parameters + 1):
            raise ValueError(
                f"the ensemble kind needs n_walkers >= 2 * (n_parameters + 1) "
                f"= {2 * (n_parameters + 1)}, got {n_walkers}"
            )
        step = ens_kernel.make_ensemble_step(
            logp_fn,
            n_walkers=n_walkers,
            alpha=alpha,
            bounds_reflect=(bounds.reflect if bounds is not None else None),
            retry=retry,
        )

        def init(walkers0, logps0, key, inv_temp=1.0):
            return ens_kernel.init_ensemble_state(
                walkers0, logps0, key, inv_temp=inv_temp
            )

        return init, step

    raise ValueError(f"unknown chain kind: {kind!r} (options: {KINDS})")


def positions_of(state):
    """The swap-exchangeable position/log-probability arrays of a state."""
    if isinstance(state, ens_kernel.EnsembleState):
        return state.walkers, state.logps
    return state.theta, state.logp


def with_positions(state, pos, logp):
    """Replace the swap-exchangeable arrays of a state."""
    if isinstance(state, ens_kernel.EnsembleState):
        return state._replace(walkers=pos, logps=logp)
    return state._replace(theta=pos, logp=logp)
