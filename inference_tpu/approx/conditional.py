"""Conditional-distribution approximations of a posterior.

JAX rebuild of the reference conditional tools
(reference: inference/approx/conditional.py:9-313): 1D conditional slices of
a posterior around a point, sampled and summarised via a piecewise-linear
inverse-transform sampler with a numerically-stable trapezium branch.

Design notes (vs the reference):

- Grid evaluations go through a single jitted+vmapped posterior program.
  The pinned variable index is a *traced* argument (a dynamic-update-slice)
  and every batch is padded to one of two fixed shapes, so a full
  ``get_conditionals`` call compiles at most two programs regardless of the
  number of variables — the reference evaluates one scalar posterior call
  per grid point.
- The threshold bisection refines **both** bracket edges simultaneously,
  one batched evaluation per iteration with masked (branchless) bracket
  updates, instead of the reference's two sequential scalar bisections
  (reference: conditional.py:33-58,160-170).
- Within-cell sampling inverts the trapezium CDF in closed form as one
  branchless vectorised quantile function, and cell selection is an
  inverse-CDF ``searchsorted`` on the cumulative cell masses
  (reference: conditional.py:61-135 uses boolean-index assignment over a
  near-zero mask plus ``rng.choice``).
- Cell masses use the trapezium-rule weights ``means * dx`` — see
  DELTAS.md #21 (the reference divides by ``dx``, which mis-weights
  non-uniform grids; reference: conditional.py:130).
"""

import numpy as np
import jax
import jax.numpy as jnp
from numpy.random import default_rng
from scipy.integrate import simpson

from ..utils.wrap import is_traceable

rng = default_rng()


class Conditional:
    """Functor pinning all-but-one variable of a posterior."""

    def __init__(self, posterior, theta, variable_index: int):
        self.posterior = posterior
        self.theta = np.asarray(theta, dtype=float)
        self.variable_index = variable_index
        self._batched = None
        self.trace_count = 0  # incremented at trace time; one per compile
        if is_traceable(posterior, self.theta):
            base = jnp.asarray(self.theta)

            def eval_batch(xs, index):
                # traced (not static) index: one compiled program serves
                # every variable, so compile count is set by the batch
                # shapes alone
                self.trace_count += 1

                def one(x):
                    return jnp.asarray(
                        self.posterior(base.at[index].set(x))
                    ).reshape(())

                return jax.vmap(one)(jnp.asarray(xs))

            self._batched = jax.jit(eval_batch)

    def __call__(self, x) -> float:
        t = self.theta.copy()
        t[self.variable_index] = x
        return float(self.posterior(t))

    def batch(self, xs) -> np.ndarray:
        """Evaluate the conditional at many points (vmapped when possible)."""
        xs = np.asarray(xs, dtype=float)
        if self._batched is not None:
            return np.asarray(self._batched(xs, self.variable_index))
        return np.array([self(x) for x in xs])

    def batch_padded(self, xs, width: int) -> np.ndarray:
        """``batch`` padded up to a fixed width so repeated calls with
        varying point counts reuse one compiled program."""
        xs = np.asarray(xs, dtype=float)
        n = xs.size
        if self._batched is None or n >= width:
            return self.batch(xs)
        return self.batch(np.pad(xs, (0, width - n), mode="edge"))[:n]


def _trapezium_quantile(u, dh):
    """
    Quantile function of the linear ("trapezium") density on [0, 1] whose
    value at t=1 exceeds the uniform density by ``dh``:
    f(t) = 1 + dh*(2t - 1), so F(t) = dh*t^2 + (1 - dh)*t and the quantile
    is the positive root of that quadratic. Where ``dh`` is tiny the
    quadratic formula cancels catastrophically; a first-order series in
    ``dh`` takes over, selected branchlessly.
    """
    u = np.asarray(u, dtype=float)
    dh = np.asarray(dh, dtype=float)
    near_zero = np.abs(dh) < 1e-5
    dh_safe = np.where(near_zero, 1.0, dh)
    b = dh - 1.0
    root = (b + np.sqrt(b * b + 4.0 * u * dh_safe)) / (2.0 * dh_safe)
    series = u + (1.0 - u) * u * dh
    return np.where(near_zero, series, root)


def piecewise_linear_sample(x, probability_density, n_samples: int) -> np.ndarray:
    """
    Sample a 1D distribution evaluated on a grid by approximating the
    density as piecewise-linear (reference behaviour: conditional.py:93-135).
    Fully vectorised: cells are drawn by inverse-CDF over the cumulative
    trapezium-rule masses, then positions within each cell by the
    closed-form trapezium quantile.
    """
    x = np.asarray(x, dtype=float)
    density = np.asarray(probability_density, dtype=float)
    dx = np.diff(x)
    if (dx <= 0.0).any():
        raise ValueError(
            "[ piecewise_linear_sample error ] The 'x' argument must be "
            "given in strictly ascending order."
        )
    if (density < 0).any():
        raise ValueError(
            "[ piecewise_linear_sample error ] All values in the given "
            "'probability_density' array must be non-negative."
        )

    p_lo, p_hi = density[:-1], density[1:]
    mass = 0.5 * (p_lo + p_hi) * dx  # trapezium-rule mass per cell
    cdf = np.cumsum(mass)
    if not np.isfinite(cdf[-1]) or cdf[-1] <= 0.0:
        # an all-zero (or non-finite) density would silently propagate
        # NaN through the inverse-CDF; fail loudly like the numpy
        # rng.choice the reference samples with (conditional.py:257)
        raise ValueError(
            "[ piecewise_linear_sample error ] The given "
            "'probability_density' has zero or non-finite total mass — "
            "the distribution cannot be sampled."
        )
    cdf /= cdf[-1]
    cells = np.searchsorted(cdf, rng.random(n_samples), side="right")
    cells = np.minimum(cells, dx.size - 1)

    mid = 0.5 * (p_lo[cells] + p_hi[cells])
    # density slope relative to the cell's uniform level; zero-mass cells
    # are (almost surely) never drawn but must not divide by zero
    dh = 0.5 * (p_hi[cells] - p_lo[cells]) / np.where(mid > 0, mid, 1.0)
    t = _trapezium_quantile(rng.random(n_samples), dh)
    return x[cells] + t * dx[cells]


def _refine_edges(
    batch_eval, target, x1, x2, y1, active, tol=0.05, max_itr=20
) -> np.ndarray:
    """
    Vectorised bisection for several threshold crossings at once: all
    brackets step together, each iteration costing one batched conditional
    evaluation, with converged/inactive rows frozen by masking. ``x1``/``y1``
    is the edge kept when the crossing lies in the lower half.
    Returns the final midpoints (rows where ``active`` is False are
    meaningless and ignored by the caller).
    """
    x1 = np.array(x1, dtype=float)
    x2 = np.array(x2, dtype=float)
    y1 = np.array(y1, dtype=float)
    done = ~np.asarray(active, dtype=bool)
    xm = 0.5 * (x1 + x2)
    for _ in range(max_itr):
        if done.all():
            break
        xm = np.where(done, xm, 0.5 * (x1 + x2))
        ym = batch_eval(xm)
        newly_done = ~done & (np.abs(ym - target) < tol)
        crossing_low = ((y1 < target) & (target < ym)) | (
            (ym < target) & (target < y1)
        )
        step = ~done & ~newly_done
        x2 = np.where(step & crossing_low, xm, x2)
        x1 = np.where(step & ~crossing_low, xm, x1)
        y1 = np.where(step & ~crossing_low, ym, y1)
        done |= newly_done
    return xm


def evaluate_conditional(func: Conditional, points, grid_size: int = 64):
    """
    Refine the mode estimate, bracket the region of non-negligible
    probability mass (an 8-nat drop from the mode), and evaluate the
    normalised conditional on a uniform grid over it
    (reference behaviour: conditional.py:138-177).
    """
    points = np.asarray(points, dtype=float)
    p = func.batch_padded(points, grid_size)
    x = points.copy()
    threshold = 8.0

    # iteratively add points around the maximum to refine the mode position
    for _ in range(6):
        ind = min(max(int(p.argmax()), 1), p.size - 2)
        x1, x2 = 0.5 * (x[ind - 1] + x[ind]), 0.5 * (x[ind + 1] + x[ind])
        p1, p2 = func.batch([x1, x2])
        x = np.insert(x, [ind, ind + 1], [x1, x2])
        p = np.insert(p, [ind, ind + 1], [p1, p2])

    p_mode = p.max()
    p_target = p_mode - threshold
    inds = (p > p_target).nonzero()[0]
    lwr_ind = max(inds[0] - 1, 0)
    upr_ind = min(inds[-1] + 1, p.size - 1)

    # both threshold crossings bisected simultaneously — one shape-(2,)
    # batched evaluation per iteration
    need_lwr = p[lwr_ind] < p_target
    need_upr = p[upr_ind] < p_target
    edges = _refine_edges(
        func.batch,
        p_target,
        x1=[x[lwr_ind + 1], x[upr_ind - 1]],
        x2=[x[lwr_ind], x[upr_ind]],
        y1=[p[lwr_ind + 1], p[upr_ind - 1]],
        active=[need_lwr, need_upr],
    )
    x_lwr = edges[0] if need_lwr else x[lwr_ind]
    x_upr = edges[1] if need_upr else x[upr_ind]

    x_cond = np.linspace(x_lwr, x_upr, grid_size)
    p_cond = func.batch(x_cond)
    p_cond = np.exp(p_cond - p_mode)
    p_cond /= simpson(p_cond, x=x_cond)
    return x_cond, p_cond


def get_conditionals(posterior, bounds, conditioning_point, grid_size: int = 64):
    """
    Evaluate each 1D conditional distribution of the posterior around a
    given point, each on a uniform grid over the range containing
    non-negligible probability.

    :return: (axes, probabilities) arrays of shape (grid_size, n_variables).
    """
    conditioning_point = np.asarray(conditioning_point, dtype=float)
    conditional = Conditional(
        posterior=posterior, theta=conditioning_point, variable_index=0
    )

    n_params = conditioning_point.size
    n_search_points = 16

    axes = np.zeros([grid_size, n_params])
    prob = np.zeros([grid_size, n_params])
    for i in range(n_params):
        conditional.variable_index = i
        search_points = np.linspace(*bounds[i], n_search_points)
        if (search_points != conditioning_point[i]).all():
            index = np.searchsorted(search_points, conditioning_point[i])
            search_points = np.insert(search_points, index, conditioning_point[i])

        x_cond, p_cond = evaluate_conditional(
            func=conditional, points=search_points, grid_size=grid_size
        )
        axes[:, i] = x_cond
        prob[:, i] = p_cond
    return axes, prob


def conditional_sample(posterior, bounds, conditioning_point, n_samples: int):
    """
    Sample each 1D conditional and combine into approximate posterior
    samples, shape (n_samples, n_parameters). A reasonable approximation
    when the posterior is close to conditionally independent.
    """
    axes, probs = get_conditionals(
        posterior=posterior, bounds=bounds, conditioning_point=conditioning_point
    )
    grid_size, n_params = probs.shape
    samples = np.zeros([n_samples, n_params])
    for i in range(n_params):
        samples[:, i] = piecewise_linear_sample(axes[:, i], probs[:, i], n_samples)
    return samples


def conditional_moments(posterior, bounds, conditioning_point):
    """
    Means and variances of the 1D conditional distributions of the
    posterior around a given point.
    """
    axes, probs = get_conditionals(
        posterior=posterior, bounds=bounds, conditioning_point=conditioning_point
    )
    grid_size, n_params = probs.shape
    means = np.zeros(n_params)
    variances = np.zeros(n_params)
    for i in range(n_params):
        means[i] = simpson(y=axes[:, i] * probs[:, i], x=axes[:, i])
        variances[i] = simpson(
            y=(axes[:, i] - means[i]) ** 2 * probs[:, i], x=axes[:, i]
        )
    return means, variances
