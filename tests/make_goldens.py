"""Generate the pinned golden fixtures in tests/goldens/.

Why pinned files: the reference's pybind ``core`` modules cannot be built in this
environment (no armadillo headers — only ``libarmadillo.so.11`` with no
``/usr/include/armadillo``; no ``pybind11``, ``autograd``, ``gym`` or ``mimo``
packages; zero network egress), so direct head-to-head goldens against
``ilqr.core.backward_pass`` / ``gps.core.backward_pass`` are infeasible (see
BASELINE.md "Golden oracle protocol").  Instead the NumPy oracle outputs
(tests/ref_impl.py — straight-loop transcriptions of ilqr/src/util.cpp:83-182 and
gps/src/util.cpp:83-374) are evaluated ONCE on fixed-seed problems and committed
as .npz fixtures.  tests/test_goldens.py compares the JAX kernels against these
frozen arrays, so kernel parity no longer depends on regenerating the oracle per
run — a change to either the kernels or the oracle replica that shifts numerics
fails the pinned test.

Run manually only when adding new fixtures:  python tests/make_goldens.py
(Regenerating existing fixtures is a deliberate act; diffs show up in git.)
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

import ref_impl

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"


def main():
    GOLDEN_DIR.mkdir(exist_ok=True)
    rng = np.random.default_rng(1337)
    T, dx, du = 25, 4, 2
    p = ref_impl.random_quadratic_problem(rng, T, dx, du, gaussian=True)

    out = {f"in_{k}": v for k, v in p.items()}

    # riccati (absolute convention, riccati/riccati.py:100-126 with matmul fix)
    K, kff, V, v = ref_impl.riccati_backward_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"], p["c"]
    )
    out.update(ric_K=K, ric_kff=kff, ric_V=V, ric_v=v)

    # ilqr, both regularization modes (ilqr/src/util.cpp:83-182)
    for reg, lmbda in ((1, 0.3), (2, 0.3)):
        K, kff, V, v, dV, diverge = ref_impl.ilqr_backward_np(
            p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["A"], p["B"],
            lmbda, reg,
        )
        assert not diverge
        out.update({
            f"ilqr{reg}_K": K, f"ilqr{reg}_kff": kff, f"ilqr{reg}_V": V,
            f"ilqr{reg}_v": v, f"ilqr{reg}_dV": dV,
        })

    # gps backward + forward + augment + kl (gps/src/util.cpp:83-374)
    alpha = np.full(T, 7.5)
    K, kff, sig, V, v, v0, diverge = ref_impl.gps_backward_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["c0"],
        p["A"], p["B"], p["c"], p["sigma_dyn"], alpha,
    )
    assert not diverge
    out.update(gps_K=K, gps_kff=kff, gps_sig=sig, gps_V=V, gps_v=v, gps_v0=v0,
               gps_alpha=alpha)

    mu0 = rng.standard_normal(dx)
    sigma0 = np.eye(dx) * 0.1
    mu_x, sigma_x, mu_u, sigma_u, mu_xu, sigma_xu = ref_impl.gaussian_forward_np(
        mu0, sigma0, p["A"], p["B"], p["c"], p["sigma_dyn"], K, kff, sig
    )
    out.update(fwd_mu0=mu0, fwd_sigma0=sigma0, fwd_mu_x=mu_x, fwd_sigma_x=sigma_x,
               fwd_mu_u=mu_u, fwd_sigma_u=sigma_u, fwd_mu_xu=mu_xu,
               fwd_sigma_xu=sigma_xu)

    agCxx, agcx, agCuu, agcu, agCxu, agc0 = ref_impl.augment_cost_np(
        p["Cxx"], p["cx"], p["Cuu"], p["cu"], p["Cxu"], p["c0"],
        K, kff, sig, alpha,
    )
    out.update(ag_Cxx=agCxx, ag_cx=agcx, ag_Cuu=agCuu, ag_cu=agcu, ag_Cxu=agCxu,
               ag_c0=agc0)

    qK = K + 0.01 * rng.standard_normal(K.shape)
    qk = kff + 0.01 * rng.standard_normal(kff.shape)
    qsig = sig + 1e-3 * np.eye(du)
    kl = ref_impl.kl_divergence_np(K, kff, sig, qK, qk, qsig,
                                   mu_x[:T], sigma_x[:T])
    out.update(kl_qK=qK, kl_qk=qk, kl_qsig=qsig, kl_kl=kl)

    np.savez_compressed(GOLDEN_DIR / "kernels.npz", **out)
    print(f"wrote {GOLDEN_DIR / 'kernels.npz'} with {len(out)} arrays")


def make_rgps_pins():
    """Regression pins for the RGPS kernel stack (cubature_forward_pass,
    policy_backward_pass, parameter_backward_pass — rgps/src/util.cpp:232-798).

    Unlike kernels.npz these are NOT independent-oracle goldens (tests/ref_impl.py
    has no straight-loop RGPS replica; correctness is established by the reduction
    tests in tests/test_rgps.py: Σθ→0 ⇒ GPS/exact-forward equivalence, β→∞ ⇒
    adversary pinned to nominal).  They FREEZE the current, reduction-validated
    implementation at fixed seeds so any future numerics drift fails loudly.
    """
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from trajopt_jax.core.cubature import (
        cubature_forward_pass,
        parameter_augment_cost,
        parameter_backward_pass,
        policy_backward_pass,
    )
    from trajopt_jax.core.types import (
        LinearGaussianPolicy,
        MatrixNormalParams,
        QuadraticCost,
    )

    rng = np.random.default_rng(2024)
    T, dx, du = 9, 3, 2
    p1 = dx + du + 1
    pdim = dx * p1
    p = ref_impl.random_quadratic_problem(rng, T, dx, du)

    cost = QuadraticCost(*[jnp.asarray(p[k]) for k in
                           ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0"]])
    theta = np.concatenate(
        [np.swapaxes(p["A"], -1, -2).reshape(T, dx * dx),
         np.swapaxes(p["B"], -1, -2).reshape(T, du * dx),
         p["c"]], axis=-1,
    )
    nominal = MatrixNormalParams(
        mu=jnp.asarray(theta),
        sigma=jnp.asarray(np.broadcast_to(1e-3 * np.eye(pdim), (T, pdim, pdim))),
    )
    ctl = LinearGaussianPolicy(
        K=jnp.asarray(0.05 * rng.standard_normal((T, du, dx))),
        kff=jnp.asarray(0.05 * rng.standard_normal((T, du))),
        sigma=jnp.asarray(np.broadcast_to(np.eye(du), (T, du, du))),
    )
    noise = jnp.asarray(np.broadcast_to(1e-4 * np.eye(dx), (T, dx, dx)))
    mu0 = jnp.asarray(rng.standard_normal(dx) * 0.1)
    sigma0 = jnp.asarray(0.01 * np.eye(dx))

    xdist, udist, xudist = cubature_forward_pass(mu0, sigma0, nominal, noise, ctl)

    agCpp, agcp, _ = parameter_augment_cost(nominal, jnp.asarray(100.0))
    param, value, div_p = parameter_backward_pass(
        xdist, ctl, noise, cost, agCpp, agcp, jnp.asarray(200.0)
    )
    assert not bool(div_p)

    lgc, pvalue, _, div_q = policy_backward_pass(
        cost, nominal, noise, jnp.full(T, 10.0)
    )
    assert not bool(div_q)

    np.savez_compressed(
        GOLDEN_DIR / "rgps_pins.npz",
        cub_mu=np.asarray(xdist.mu), cub_sigma=np.asarray(xdist.sigma),
        cub_umu=np.asarray(udist.mu), cub_usigma=np.asarray(udist.sigma),
        adv_mu=np.asarray(param.mu), adv_sigma=np.asarray(param.sigma),
        pol_K=np.asarray(lgc.K), pol_kff=np.asarray(lgc.kff),
        pol_sigma=np.asarray(lgc.sigma),
        in_theta=theta, in_K=np.asarray(ctl.K), in_kff=np.asarray(ctl.kff),
        in_mu0=np.asarray(mu0),
        **{f"in_{k}": p[k] for k in ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0",
                                     "A", "B", "c"]},
    )
    print(f"wrote {GOLDEN_DIR / 'rgps_pins.npz'}")


if __name__ == "__main__":
    if "--rgps" in sys.argv:
        make_rgps_pins()
    else:
        main()
