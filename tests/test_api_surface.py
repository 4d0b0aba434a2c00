"""Automated API-surface audit against the reference implementation.

SURVEY.md section 2 inventories the reference's public components; this test
walks the reference's actual import surface (classes, functions, their public
methods and constructor parameters) and asserts each has a counterpart here,
so a parity gap introduced by either side shows up as a test failure instead
of a documentation drift. Intentional differences must be listed in the
explicit allowlists below, each of which is recorded in DELTAS.md.

Reference modules audited: inference.{mcmc,gp,pdf,likelihoods,priors,
plotting,approx,posterior} (reference: inference/__init__.py and submodule
``__all__`` lists).
"""

import inspect
import sys
import types

import pytest


def _reference():
    mod = types.ModuleType("setuptools_scm")
    mod.get_version = lambda **k: "0.0.0"
    sys.modules.setdefault("setuptools_scm", mod)
    if "/root/reference" not in sys.path:
        sys.path.insert(0, "/root/reference")
    try:
        import inference  # noqa: F401

        return True
    except Exception:
        return False


pytestmark = pytest.mark.skipif(
    not _reference(), reason="reference implementation not available"
)

# reference module -> counterpart module(s) searched in order
MODULE_MAP = {
    "inference.mcmc": ["inference_tpu.mcmc", "inference_tpu.parallel"],
    "inference.gp": ["inference_tpu.gp"],
    "inference.pdf": ["inference_tpu.pdf"],
    "inference.likelihoods": ["inference_tpu.models"],
    "inference.priors": ["inference_tpu.models"],
    "inference.plotting": ["inference_tpu.plotting"],
    "inference.approx": ["inference_tpu.approx"],
    "inference.posterior": ["inference_tpu.models"],
}

# reference symbols with no counterpart, each justified in DELTAS.md
SYMBOL_ALLOWLIST = {
    # internal validation helpers the reference leaks through sloppy
    # `from x import *`-style surfaces; not part of its documented API.
    # jacobian_not_given (likelihoods.py:267) is a module-level default-arg
    # sentinel that raises; the rebuild raises the same error from an
    # instance check. attempt_array_conversion (priors.py:565) is a private
    # isinstance helper subsumed by models.priors._convertible.
    "jacobian_not_given",
    "attempt_array_conversion",
}

# (class name, method/attr name) pairs with no counterpart, per DELTAS.md
METHOD_ALLOWLIST = {
    # reference-internal hooks of its multiprocessing layer; the rebuilt
    # ParallelTempering drives chains in-process / on-device (DELTAS.md)
    ("ParallelTempering", "shutdown_pools"),
    ("ChainPool", "adv_func"),
    # implementation internals the reference leaves public-named (no
    # leading underscore) but never documents as API: per-step numerics
    # helpers that are fused inside compiled kernels here (DELTAS.md #22)
    ("PcaChain", "pass_through"),
    ("EnsembleSampler", "pass_through"),
    ("HamiltonianChain", "hamiltonian"),
    ("HamiltonianChain", "standard_leapfrog"),
    ("HamiltonianChain", "bounded_leapfrog"),
    ("HamiltonianChain", "kinetic_energy"),
    ("HamiltonianChain", "finite_diff"),
    ("ExpectedImprovement", "ln_pdf"),
    ("ExpectedImprovement", "cdf_pdf_ratio"),
    ("ExpectedImprovement", "normal_cdf"),
    ("ExpectedImprovement", "normal_pdf"),
    ("ChangePoint", "logistic_and_gradient"),
    ("GaussianKDE", "log_kernel"),
    ("GaussianKDE", "log_evaluation"),
    ("GaussianKDE", "cross_validation_logprob"),
    ("UnimodalPdf", "pdf_model"),
    ("UnimodalPdf", "log_pdf_model"),
    ("UnimodalPdf", "norm"),
}

# (class name, parameter) constructor params with no counterpart
PARAM_ALLOWLIST = set()


def _ref_public(modname):
    import importlib

    mod = importlib.import_module(modname)
    names = getattr(mod, "__all__", None) or [
        n for n in dir(mod) if not n.startswith("_")
    ]
    out = {}
    for n in names:
        obj = getattr(mod, n, None)
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        # only symbols the reference itself defines (not numpy/abc/itertools
        # names leaked by its import style)
        if not getattr(obj, "__module__", "").startswith("inference"):
            continue
        out[n] = obj
    return out


def _find_counterpart(name):
    import importlib

    candidates = set()
    for mods in MODULE_MAP.values():
        candidates.update(mods)
    for m in sorted(candidates):
        mod = importlib.import_module(m)
        if hasattr(mod, name):
            return getattr(mod, name)
    return None


def test_every_reference_symbol_has_a_counterpart():
    import importlib

    missing = []
    for refmod, ourmods in MODULE_MAP.items():
        for name in _ref_public(refmod):
            if name in SYMBOL_ALLOWLIST:
                continue
            found = False
            for m in ourmods:
                if hasattr(importlib.import_module(m), name):
                    found = True
                    break
            if not found:
                missing.append(f"{refmod}.{name}")
    assert not missing, f"reference symbols without counterparts: {missing}"


def _public_methods(cls):
    out = set()
    for n, obj in inspect.getmembers(cls):
        if n.startswith("_"):
            continue
        if callable(obj) or isinstance(obj, property):
            # only methods defined by the reference package itself
            owner = getattr(obj, "__module__", "") or ""
            if isinstance(obj, property):
                owner = getattr(obj.fget, "__module__", "") or ""
            if owner.startswith("inference"):
                out.add(n)
    return out


def _iter_ref_classes():
    seen = set()
    for refmod in MODULE_MAP:
        for name, obj in _ref_public(refmod).items():
            if name in SYMBOL_ALLOWLIST or not inspect.isclass(obj):
                continue
            if name in seen:
                continue
            seen.add(name)
            yield name, obj


def test_every_reference_public_method_has_a_counterpart():
    missing = []
    for name, ref_cls in _iter_ref_classes():
        ours = _find_counterpart(name)
        if ours is None:
            continue  # covered by the symbol test
        ref_methods = _public_methods(ref_cls)
        for m in ref_methods:
            if (name, m) in METHOD_ALLOWLIST:
                continue
            if not hasattr(ours, m):
                missing.append(f"{name}.{m}")
    assert not missing, f"reference methods without counterparts: {missing}"


def test_constructor_parameters_are_accepted():
    """Every keyword a reference constructor accepts is accepted here too
    (extra keywords of this package are fine; *fewer* would break drop-in use)."""
    missing = []
    for name, ref_cls in _iter_ref_classes():
        ours = _find_counterpart(name)
        if ours is None or not inspect.isclass(ours):
            continue
        try:
            ref_sig = inspect.signature(ref_cls.__init__)
            our_sig = inspect.signature(ours.__init__)
        except (ValueError, TypeError):
            continue
        our_params = set(our_sig.parameters)
        has_var_kw = any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in our_sig.parameters.values()
        )
        for p, param in ref_sig.parameters.items():
            if p in ("self",) or param.kind in (
                inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD,
            ):
                continue
            if (name, p) in PARAM_ALLOWLIST:
                continue
            if p not in our_params and not has_var_kw:
                missing.append(f"{name}({p})")
    assert not missing, f"reference constructor params not accepted: {missing}"


def test_module_level_functions_signature_compat():
    """Public reference functions: our counterparts accept at least the
    reference's named parameters."""
    problems = []
    for refmod, ourmods in MODULE_MAP.items():
        for name, obj in _ref_public(refmod).items():
            if not inspect.isfunction(obj) or name in SYMBOL_ALLOWLIST:
                continue
            ours = _find_counterpart(name)
            if ours is None:
                continue
            try:
                ref_sig = inspect.signature(obj)
                our_sig = inspect.signature(ours)
            except (ValueError, TypeError):
                continue
            our_params = set(our_sig.parameters)
            has_var_kw = any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in our_sig.parameters.values()
            )
            for p, param in ref_sig.parameters.items():
                if param.kind in (
                    inspect.Parameter.VAR_POSITIONAL,
                    inspect.Parameter.VAR_KEYWORD,
                ):
                    continue
                if p not in our_params and not has_var_kw:
                    problems.append(f"{name}({p})")
    assert not problems, f"function params not accepted: {problems}"
