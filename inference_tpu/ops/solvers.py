"""Mixed-precision preconditioned conjugate gradients.

``jax.scipy.sparse.linalg.cg`` carries its residual by recursion; in
float32 at condition numbers ≳1e6 the recursive residual drifts from the
true one and the returned "solution" can be worse than the starting point
(observed on the small-noise GP systems in ``gp/large_scale.py``). This
solver keeps the expensive objects — vectors, the matvec, the
preconditioner — in float32, but:

- computes every scalar reduction (p·Ap, r·z, ‖r‖) in float64, and
- recomputes the TRUE residual ``b - A x`` every ``restart_every``
  iterations, killing recursion drift outright.

This is the classic restarted mixed-precision PCG; combined with
``LargeScaleGP.refine()`` it extends float32 CG to condition numbers the
library's default solver cannot touch.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .df64 import split_pair


def mixed_pcg(matvec, b, M=None, tol=1e-6, maxiter=1000, restart_every=50):
    """
    Solve ``A x = b`` (A symmetric positive-definite, applied by
    ``matvec``) by preconditioned CG with float64 scalar recurrences and
    periodic true-residual restarts. Requires ``jax_enable_x64`` for the
    f64 scalars; vectors stay in ``b``'s dtype.

    Returns ``(x, info)`` with ``info = 0`` on convergence (mirroring the
    jax.scipy API shape; ``info`` is the final iteration count otherwise).
    """
    if not jax.config.read("jax_enable_x64"):
        raise ValueError(
            "mixed_pcg requires jax_enable_x64: without it the float64 "
            "scalar recurrences silently truncate to float32 and the "
            "solver loses exactly the precision it exists to provide"
        )
    if M is None:
        M = lambda v: v
    f64 = jnp.float64
    vdtype = b.dtype

    def dot64(u, v):
        return jnp.sum(u.astype(f64) * v.astype(f64))

    b_norm = jnp.sqrt(dot64(b, b))
    atol2 = (tol * b_norm) ** 2

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = M(r0)
    p0 = z0
    rz0 = dot64(r0, z0)

    def cond(s):
        i, x, r, z, p, rz, rr, ok = s
        return ok & (i < maxiter) & (rr > atol2)

    def body(s):
        i, x, r, z, p, rz, rr, ok = s
        Ap = matvec(p)
        pAp = dot64(p, Ap)
        # breakdown guard: a non-positive curvature in exact arithmetic is
        # impossible for SPD A; in float32 it signals total loss of
        # precision — stop with the current iterate
        ok = ok & (pAp > 0.0)
        alpha = jnp.where(pAp > 0.0, rz / pAp, 0.0)
        x = x + alpha.astype(vdtype) * p

        restart = (i % restart_every) == (restart_every - 1)

        def true_residual(_):
            return b - matvec(x)

        def recurrent_residual(_):
            return r - alpha.astype(vdtype) * Ap

        r = lax.cond(restart, true_residual, recurrent_residual, None)
        z = M(r)
        rz_new = dot64(r, z)
        rr = dot64(r, r)
        # after a true-residual restart the old direction (built from the
        # NOISY float32 recurrence) is no longer conjugate to the fresh
        # residual — reset to steepest descent. Measured on a kappa=1e6
        # SPD test: with the f32 matvec this reset is the difference
        # between a 7e-7 floor and outright divergence. (The opposite
        # holds in df64_pcg, whose matvec is accurate: there the refresh
        # is a tiny perturbation of the same Krylov process and the
        # direction must be KEPT — resetting wrecks convergence.)
        beta = jnp.where((rz != 0.0) & ~restart, rz_new / rz, 0.0)
        p = z + beta.astype(vdtype) * p
        return (i + 1, x, r, z, p, rz_new, rr, ok)

    init = (
        jnp.asarray(0, jnp.int32),
        x0,
        r0,
        z0,
        p0,
        rz0,
        dot64(r0, r0),
        jnp.asarray(True),
    )
    i, x, r, *_ = lax.while_loop(cond, body, init)
    rr = dot64(r, r)
    info = jnp.where(rr <= atol2, 0, i)
    return x, info


def pcg_multi(matvec, B, M=None, tol=1e-6, maxiter=1000, restart_every=50):
    """
    Preconditioned CG over MANY right-hand sides at once: ``B`` is
    (n, q) and every iteration applies ONE shared matrix-matvec
    ``matvec(P)`` to all q systems (a kernel-block matmul against a
    (n, q) matrix costs barely more than against a single vector, where
    q sequential CG runs pay the full O(n^2) sweep q times —
    this is what makes batched posterior variances cheap). Scalar
    recurrences are per-column; converged columns freeze via masking.

    Like ``mixed_pcg``, the per-column scalar reductions run in float64
    when ``jax_enable_x64`` is on (cheap: O(q) scalars), and the
    TRUE residual ``B - A X`` is recomputed every ``restart_every``
    iterations with the search directions reset to steepest descent —
    without these, float32 recursion drift makes CG "converge" to wrong
    answers at condition numbers >= 1e6 (the small-noise GP regime whose
    posterior-variance solves this function serves).

    Returns ``(X, info)`` with ``info`` the number of iterations run.
    """
    if M is None:
        M = lambda v: v
    dtype = B.dtype
    sdtype = jnp.float64 if jax.config.read("jax_enable_x64") else dtype

    def colsum(U, V):
        return jnp.sum(U.astype(sdtype) * V.astype(sdtype), axis=0)

    atol2 = (tol**2) * colsum(B, B)
    X = jnp.zeros_like(B)
    R = B
    Z = M(R)
    P = Z
    rz = colsum(R, Z)
    active0 = colsum(R, R) > atol2

    def cond(s):
        i, X, R, Z, P, rz, active = s
        return jnp.any(active) & (i < maxiter)

    def body(s):
        i, X, R, Z, P, rz, active = s
        AP = matvec(P)
        pAp = colsum(P, AP)
        ok = active & (pAp > 0.0)
        alpha = jnp.where(ok, rz / jnp.where(pAp > 0.0, pAp, 1.0), 0.0)
        X = X + alpha[None, :].astype(dtype) * P

        restart = (i % restart_every) == (restart_every - 1)
        R = lax.cond(
            restart,
            lambda _: B - matvec(X),
            lambda _: R - alpha[None, :].astype(dtype) * AP,
            None,
        )
        Z = M(R)
        rz_new = colsum(R, Z)
        rr = colsum(R, R)
        active = ok & (rr > atol2)
        # the noisy-f32-matvec direction is no longer conjugate to a
        # freshly recomputed residual — reset to steepest descent at
        # restarts (same reasoning as mixed_pcg)
        beta = jnp.where(
            active & (rz != 0.0) & ~restart,
            rz_new / jnp.where(rz != 0.0, rz, 1.0),
            0.0,
        )
        P = Z + beta[None, :].astype(dtype) * P
        return (i + 1, X, R, Z, P, rz_new, active)

    i, X, *_ = lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), X, R, Z, P, rz, active0)
    )
    return X, i


# CG iterations between true-residual refreshes of the df64 solvers: one
# compiled chunk per refresh period
DF64_RESTART_EVERY = 50


class Df64Solver:
    """
    Preconditioned CG with **float64 iterate/residual vectors** and a
    double-float matvec: ``matvec64`` maps a *float32* vector to the
    float64 result of ``A v`` with ~1e-8 relative accuracy (e.g.
    ``ops.df64.sqexp_matvec_df64`` plus diagonal terms). This is the solver
    for the small-noise GP regime where ``mixed_pcg``'s float32 matvec
    noise (~1e-5 at N ~ 16k) exceeds the achievable residual:

    - x and r are float64,
    - search directions are applied through the matvec in float32 (a
      direction only needs eps32 relative accuracy),
    - iterations run in compiled chunks of ``restart_every``, each chunk
      ending with a TRUE residual ``b - A x_hi - A x_lo`` (x split into a
      float32 pair), so the recurrence never drifts beyond the matvec's
      own ~1e-8 (the search direction and beta carry across the refresh —
      it is a perturbation of the same Krylov process, not a restart:
      resetting p there was measured to wreck convergence, see
      tests/test_df64.py),
    - the preconditioner ``M`` receives the **float64** residual and its
      output is used in float64: high-dynamic-range preconditioners (a
      Woodbury application at sigma ~ 1e-2 has core condition ~1e8-1e9
      and ~8-digit cancellation in its subtraction) must be applied in
      f64 — an f32 application was measured to stall PCG at 1e-4..1e-6
      even with an exact f64 matvec, while f64 application converges to
      1e-12 in <50 iterations on the same system,
    - the HOST drives the chunk loop: one device dispatch per chunk (one
      true-residual refresh period) pulls only one scalar per chunk and
      lets the host keep each column's best iterate (see
      ``Df64MultiSolver.solve``).

    Construct once per operator (the compiled chunk is cached on the
    instance) and call ``solve`` per right-hand side.
    """

    def __init__(
        self,
        matvec64,
        M=None,
        M_args=(),
        matvec_args=(),
        restart_every: int = DF64_RESTART_EVERY,
        matvec_fast=None,
        matvec_fast_args=(),
    ):
        """``matvec64(v, *matvec_args)`` applies the operator to a
        float32 vector and ``M(v, *M_args)`` applies the preconditioner
        to the float64 residual (apply it IN float64 unless it is
        diagonal — see the class docstring); both argument tuples are
        passed as runtime operands on every dispatch — an operator or
        preconditioner closing over a large array (an (N, m) factor, an
        (M, N) model matrix) would bake it into the compiled program as a
        constant (the compile-payload trap documented in
        gp/large_scale.py). ``matvec_fast``, when given, runs the
        iteration matvecs while ``matvec64`` anchors the true-residual
        refreshes (see ``Df64MultiSolver``)."""
        # a single right-hand side is exactly the q=1 column block of the
        # multi-RHS solver (the per-column scalar recurrences reduce to
        # scalars): delegate instead of maintaining two copies of the
        # delicate chunked-PCG logic in lockstep
        def matmat64(V, *args):
            return matvec64(V[:, 0], *args)[:, None]

        M_multi = None
        if M is not None:
            def M_multi(R, *args):
                return jnp.asarray(M(R[:, 0], *args))[:, None]

        matmat_fast = None
        if matvec_fast is not None:
            def matmat_fast(V, *args):
                return matvec_fast(V[:, 0], *args)[:, None]

        self._multi = Df64MultiSolver(
            matmat64,
            M=M_multi,
            M_args=M_args,
            matmat_args=matvec_args,
            restart_every=restart_every,
            matmat_fast=matmat_fast,
            matmat_fast_args=matvec_fast_args,
            _label="Df64Solver",
        )
        self.restart_every = self._multi.restart_every

    def solve(self, b64, tol=1e-10, maxiter=2000, verbose=False):
        """Returns ``(x, info)`` with float64 ``x``; ``info = 0`` on
        convergence, else the iteration count reached (chunk granularity,
        capped at ``maxiter``). ``verbose`` prints the per-chunk relative
        residual — long large-N solves run many minutes and are otherwise
        silent."""
        b64 = jnp.asarray(b64, jnp.float64)
        X, info = self._multi.solve(
            b64[:, None], tol=tol, maxiter=maxiter, verbose=verbose
        )
        return X[:, 0], info


class Df64MultiSolver:
    """
    Multi-right-hand-side counterpart of ``Df64Solver``: the same
    chunked, host-driven float64-vector PCG, run over a (n, q) block of
    systems at once through a ``matmat64`` operator (e.g.
    ``ops.df64.sqexp_matmat_df64`` plus diagonal terms), which amortises
    the expensive ENTRY evaluation across columns. Scalar recurrences are per-column float64;
    a column that hits a pAp <= 0 breakdown freezes (its ok flag drops)
    while the others keep iterating; the host loop stops when every
    column is converged or broken.

    Used for batched posterior-variance solves in the small-noise GP
    regime (``gp/large_scale.py``), where each query point is one column
    and the f64-applied preconditioner converges them in ~10 iterations.
    """

    def __init__(
        self,
        matmat64,
        M=None,
        M_args=(),
        matmat_args=(),
        restart_every: int = DF64_RESTART_EVERY,
        matmat_fast=None,
        matmat_fast_args=(),
        _label: str = "Df64MultiSolver",
    ):
        """``matmat64(V, *matmat_args)`` maps a float32 (n, q) block to
        the float64 (n, q) result of ``A V``; ``M(R, *M_args)`` applies
        the preconditioner to the float64 (n, q) residual block (in
        float64 — see ``Df64Solver``). Argument tuples travel as runtime
        operands (the compile-payload trap).

        ``matmat_fast(V, *matmat_fast_args)``, when given, is a CHEAPER
        application of (an approximation of) the same operator — e.g. the
        stored-f32-entries contraction, whose only error is the 2^-24
        entry quantisation — used for the chunk's ITERATION matvecs; the
        end-of-chunk true-residual refresh always goes through the
        accurate ``matmat64``, so the scheme is mixed-precision iterative
        refinement: each chunk contracts the error by roughly
        kappa(M^-1 A) times the fast operator's relative error, and the
        attainable floor is set by ``matmat64`` alone."""
        self._label = _label
        if not jax.config.read("jax_enable_x64"):
            raise ValueError(
                f"{_label} requires jax_enable_x64 (float64 "
                "iterate vectors)"
            )
        self.matmat64 = matmat64
        self.M = M if M is not None else (lambda V: V)
        self.M_args = tuple(M_args)
        self.matmat_args = tuple(matmat_args)
        self.matmat_fast = matmat_fast
        self.matmat_fast_args = tuple(matmat_fast_args)
        self.restart_every = int(restart_every)
        self._chunk = jax.jit(self._build_chunk())

    def _build_chunk(self):
        matmat64_outer, M_outer = self.matmat64, self.M
        fast_outer = self.matmat_fast
        f32, f64 = jnp.float32, jnp.float64
        n_iter = self.restart_every

        def colsum(U, V):
            return jnp.sum(U * V, axis=0)

        def chunk(B64, X, R, Z, P, rz, ok, M_args, mm_args, fast_args):
            def M(V):
                return M_outer(V, *M_args)

            def matmat64(V):
                return matmat64_outer(V, *mm_args)

            if fast_outer is None:
                matmat_iter = matmat64
            else:
                def matmat_iter(V):
                    return fast_outer(V, *fast_args)

            def body(_, s):
                X, R, Z, P, rz, ok = s
                P32 = P.astype(f32)
                AP = matmat_iter(P32)
                P_applied = P32.astype(f64)
                pAp = colsum(P_applied, AP)
                # per-column breakdown latch (see Df64Solver)
                ok = ok & (pAp > 0.0)
                alpha = jnp.where(
                    ok, rz / jnp.where(pAp > 0.0, pAp, 1.0), 0.0
                )
                X = X + alpha[None, :] * P_applied
                R = R - alpha[None, :] * AP
                Z = M(R).astype(f64)
                rz_new = colsum(R, Z)
                beta = jnp.where(
                    ok & (rz != 0.0),
                    rz_new / jnp.where(rz != 0.0, rz, 1.0),
                    0.0,
                )
                P = Z + beta[None, :] * P
                return (X, R, Z, P, rz_new, ok)

            X, R, Z, P, rz, ok = lax.fori_loop(
                0, n_iter, body, (X, R, Z, P, rz, ok)
            )
            # end-of-chunk true-residual refresh
            Xh, Xl = split_pair(X)
            if fast_outer is None:
                R = B64 - matmat64(Xh) - matmat64(Xl)
            else:
                # the LOW split word rides the fast operator: |Xl| is
                # ~eps32 of |X|, so the fast operator's own relative
                # error (entry quantisation ~2^-24) contributes
                # ~2^-48|X| to the refresh — far below the accurate
                # kernel's floor — and the refresh pays ONE accurate
                # matvec instead of two
                R = B64 - matmat64(Xh) - matmat_iter(Xl)
            Z = M(R).astype(f64)
            rz = colsum(R, Z)
            rr = colsum(R, R)
            if fast_outer is None:
                # directions carry over: iterations and refresh apply the
                # SAME operator, so this is a perturbation of one Krylov
                # process (resetting p here was measured to wreck
                # convergence — see Df64Solver / tests/test_df64.py)
                pass
            else:
                # iterations ran on the FAST operator: a direction from
                # its Krylov space coupled to the accurate refreshed
                # residual diverges (measured: converges to the fast
                # floor in chunk 1, then residuals grow ~1e10 per 50
                # iterations) — restart steepest-descent, the textbook
                # inexact-inner iterative-refinement structure
                P = Z
            return X, R, Z, P, rz, ok, rr

        return chunk

    def solve(self, B64, tol=1e-10, maxiter=2000, verbose=False):
        """Returns ``(X, info)`` with float64 (n, q) ``X``; ``info = 0``
        when every column converged, else the iteration count reached.

        The host loop safeguards against near-floor divergence: carrying
        the search direction across a true-residual refresh is a tiny
        perturbation of one Krylov process while the residual is far
        from the attainable floor, but AT the floor the refresh-vs-
        recurrence mismatch feeds the beta recurrence and the iteration
        can grow geometrically instead of stagnating (measured at
        N=50,000, sigma=0.01: residual 3.9e-9 after chunk 1, 1.4e+15
        after chunk 2, nan after chunk 3 — rz and pAp positive
        throughout, ~2.7x growth per iteration), and on operators
        carrying storage quantisation the in-chunk pAp latch fires when
        inner CG digs below the quantisation depth. Each column
        therefore keeps its best-known state. A TROUBLED chunk — the
        pAp latch fired, the residual went non-finite, or it grew
        1000x in norm past the best (far outside healthy CG
        oscillation, which does spike orders of magnitude while the
        A-norm error still falls: a 16x trigger was measured to freeze
        a healthy solve at 3e-4 instead of its 1e-7 floor; the
        measured divergence grows ~390x per 6-iteration chunk) — ends
        early for that column: it is restored to its best state when
        worse, reset to steepest descent, and RESUMED. A troubled
        chunk that still improved the best costs nothing; two
        consecutive no-progress setbacks freeze the column (it is at
        its attainable floor). The returned ``X`` is every column's
        best iterate."""
        B64 = jnp.asarray(B64, jnp.float64)
        bb = jnp.sum(B64 * B64, axis=0)
        atol2 = (float(tol) ** 2) * np.asarray(bb)
        X = jnp.zeros_like(B64)
        R = B64
        Z = jnp.asarray(self.M(R, *self.M_args), jnp.float64)
        P = Z
        rz = jnp.sum(R * Z, axis=0)
        q = B64.shape[1]
        ok = jnp.ones(q, bool)
        done = 0
        rr_host = np.asarray(bb)
        # already-converged right-hand sides (zero columns, a refine
        # round whose predecessor finished the job) must not pay a full
        # compiled chunk of kernel matvecs
        if np.all(rr_host <= atol2):
            return X, 0
        best = {"X": X, "R": R, "Z": Z, "rz": rz, "rr": rr_host.copy()}
        setbacks = np.zeros(q, np.int32)
        frozen = np.zeros(q, bool)
        while done < maxiter:
            X, R, Z, P, rz, ok, rr = self._chunk(
                B64, X, R, Z, P, rz, ok,
                self.M_args, self.matmat_args, self.matmat_fast_args,
            )
            done += self.restart_every
            rr_host = np.asarray(rr)
            ok_host = np.asarray(ok)
            finite = np.isfinite(rr_host)
            improved = finite & (rr_host < best["rr"])
            if improved.any():
                sel = jnp.asarray(improved)
                best["X"] = jnp.where(sel[None, :], X, best["X"])
                best["R"] = jnp.where(sel[None, :], R, best["R"])
                best["Z"] = jnp.where(sel[None, :], Z, best["Z"])
                best["rz"] = jnp.where(sel, rz, best["rz"])
                best["rr"] = np.where(improved, rr_host, best["rr"])
            converged = best["rr"] <= atol2
            # a troubled chunk: the in-chunk pAp latch fired (precision
            # breakdown at the operator's quantisation depth), the
            # residual is non-finite, or it grew 1000x in norm past the
            # best (1e6 on rr — beyond any healthy CG oscillation, which
            # DOES spike orders of magnitude over the running best while
            # the A-norm error still falls, yet within ~1 chunk of the
            # measured ~390x-per-6-iteration divergence)
            # frozen columns are excluded: they no longer iterate, so
            # their permanently-cleared ok flag is not a NEW breakdown
            # (without this they would re-count as troubled every chunk,
            # inflating setbacks and the verbose diagnostics)
            trouble = ~converged & ~frozen & (
                ~ok_host
                | ~finite
                | (rr_host > 1e6 * np.maximum(best["rr"], atol2))
            )
            # a troubled chunk that still improved its best costs
            # nothing (breakdown after real progress); one that made no
            # progress is a setback, and two consecutive setbacks mean
            # the column is AT its attainable floor — freeze it
            setbacks = np.where(improved, 0, setbacks + trouble)
            frozen |= setbacks >= 2
            if trouble.any():
                worse = trouble & (~finite | (rr_host > best["rr"]))
                sel = jnp.asarray(worse)
                X = jnp.where(sel[None, :], best["X"], X)
                R = jnp.where(sel[None, :], best["R"], R)
                Z = jnp.where(sel[None, :], best["Z"], Z)
                rz = jnp.where(sel, best["rz"], rz)
                # steepest descent for every troubled column: the
                # carried direction is what broke or diverged
                P = jnp.where(jnp.asarray(trouble)[None, :], Z, P)
                rr_host = np.where(worse, best["rr"], rr_host)
                if verbose:
                    print(
                        f"  [ {self._label}: iteration {done}, "
                        f"{int(trouble.sum())} column(s) troubled "
                        f"(breakdown/divergence) — reset, "
                        f"{int(frozen.sum())} frozen ]",
                        flush=True,
                    )
            # resurrect latched columns that are not frozen: an in-chunk
            # breakdown ends the chunk early for that column, it does
            # not end the solve
            ok = jnp.asarray(~frozen & ~converged)
            if verbose:
                rel = np.sqrt(
                    rr_host / np.where(atol2 > 0, np.asarray(bb), 1.0)
                )
                print(
                    f"  [ {self._label}: iteration {done}, worst "
                    f"relative residual {rel.max():.3e} ]",
                    flush=True,
                )
            if np.all(converged | frozen):
                break
        final_rr = np.minimum(rr_host, best["rr"])
        X = jnp.where(jnp.asarray(best["rr"] <= rr_host)[None, :], best["X"], X)
        info = 0 if np.all(final_rr <= atol2) else min(done, maxiter)
        return X, info


def df64_pcg(
    matvec64, b64, M=None, tol=1e-10, maxiter=2000,
    restart_every=DF64_RESTART_EVERY,
):
    """Functional wrapper over ``Df64Solver`` (compiles its chunk per
    call — construct a ``Df64Solver`` directly to reuse it across
    right-hand sides)."""
    solver = Df64Solver(matvec64, M=M, restart_every=restart_every)
    return solver.solve(b64, tol=tol, maxiter=maxiter)
