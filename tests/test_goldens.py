"""Pinned-golden parity tests.

The JAX kernels are compared against FROZEN fixture arrays
(tests/goldens/kernels.npz, generated once by tests/make_goldens.py from the
NumPy oracle replicas of the reference C++ — ilqr/src/util.cpp:83-182,
gps/src/util.cpp:83-374, riccati/riccati.py:100-126).  Unlike the per-run oracle
tests, these cannot drift: a numerics change in either the kernels or the oracle
replica fails here until the fixture regeneration is an explicit, reviewed act.
See BASELINE.md "Golden oracle protocol" for why the reference's own pybind cores
cannot be built in this environment.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from trajopt_jax.core.scan_lqr import (
    augment_cost_kl,
    gaussian_forward,
    gps_backward,
    ilqr_backward,
    policy_kl,
    riccati_backward,
)
from trajopt_jax.core.types import (
    GaussianSequence,
    LinearDynamics,
    LinearGaussianDynamics,
    LinearGaussianPolicy,
    QuadraticCost,
)

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "kernels.npz"


@pytest.fixture(scope="module")
def g():
    assert GOLDEN.exists(), "run tests/make_goldens.py to create the fixture"
    return np.load(GOLDEN)


def _cost(g):
    return QuadraticCost(*[
        jnp.asarray(g[f"in_{k}"]) for k in ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0"]
    ])


def test_riccati_golden(g):
    dyn = LinearDynamics(
        A=jnp.asarray(g["in_A"]), B=jnp.asarray(g["in_B"]), c=jnp.asarray(g["in_c"])
    )
    ctl, value = riccati_backward(_cost(g), dyn)
    np.testing.assert_allclose(np.asarray(ctl.K), g["ric_K"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ctl.kff), g["ric_kff"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(value.V), g["ric_V"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.v), g["ric_v"], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("reg", [1, 2])
def test_ilqr_golden(g, reg):
    ctl, value, _, dV, diverged = ilqr_backward(
        _cost(g), jnp.asarray(g["in_A"]), jnp.asarray(g["in_B"]), 0.3, reg
    )
    assert not bool(diverged)
    np.testing.assert_allclose(np.asarray(ctl.K), g[f"ilqr{reg}_K"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(ctl.kff), g[f"ilqr{reg}_kff"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(value.V), g[f"ilqr{reg}_V"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.v), g[f"ilqr{reg}_v"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(dV), g[f"ilqr{reg}_dV"], rtol=1e-9, atol=1e-11)


def _gdyn(g):
    return LinearGaussianDynamics(
        A=jnp.asarray(g["in_A"]), B=jnp.asarray(g["in_B"]),
        c=jnp.asarray(g["in_c"]), sigma=jnp.asarray(g["in_sigma_dyn"]),
    )


def test_gps_backward_golden(g):
    lgc, value, _, diverged = gps_backward(_cost(g), _gdyn(g), jnp.asarray(g["gps_alpha"]))
    assert not bool(diverged)
    np.testing.assert_allclose(np.asarray(lgc.K), g["gps_K"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(lgc.kff), g["gps_kff"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(lgc.sigma), g["gps_sig"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(value.V), g["gps_V"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.v), g["gps_v"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(value.v0), g["gps_v0"], rtol=1e-9, atol=1e-9)


def _policy(g):
    return LinearGaussianPolicy(
        K=jnp.asarray(g["gps_K"]), kff=jnp.asarray(g["gps_kff"]),
        sigma=jnp.asarray(g["gps_sig"]),
    )


def test_gaussian_forward_golden(g):
    xdist, udist, xudist = gaussian_forward(
        _gdyn(g), _policy(g), jnp.asarray(g["fwd_mu0"]), jnp.asarray(g["fwd_sigma0"])
    )
    np.testing.assert_allclose(np.asarray(xdist.mu), g["fwd_mu_x"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(xdist.sigma), g["fwd_sigma_x"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(udist.mu), g["fwd_mu_u"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(udist.sigma), g["fwd_sigma_u"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(xudist.mu), g["fwd_mu_xu"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(xudist.sigma), g["fwd_sigma_xu"], rtol=1e-9, atol=1e-12)


def test_augment_cost_golden(g):
    ag = augment_cost_kl(_cost(g), _policy(g), jnp.asarray(g["gps_alpha"]))
    for field, key in [("Cxx", "ag_Cxx"), ("cx", "ag_cx"), ("Cuu", "ag_Cuu"),
                       ("cu", "ag_cu"), ("Cxu", "ag_Cxu"), ("c0", "ag_c0")]:
        np.testing.assert_allclose(
            np.asarray(getattr(ag, field)), g[key], rtol=1e-9, atol=1e-10,
            err_msg=field,
        )


def test_policy_kl_golden(g):
    T = g["in_A"].shape[0]
    q = LinearGaussianPolicy(
        K=jnp.asarray(g["kl_qK"]), kff=jnp.asarray(g["kl_qk"]),
        sigma=jnp.asarray(g["kl_qsig"]),
    )
    xdist = GaussianSequence(
        mu=jnp.asarray(g["fwd_mu_x"][:T]), sigma=jnp.asarray(g["fwd_sigma_x"][:T])
    )
    kl = policy_kl(_policy(g), q, xdist)
    np.testing.assert_allclose(np.asarray(kl), g["kl_kl"], rtol=1e-9, atol=1e-11)


class TestRgpsPins:
    """Regression pins for the RGPS kernel stack (tests/goldens/rgps_pins.npz —
    frozen outputs of the reduction-validated implementation at fixed seeds;
    see make_goldens.make_rgps_pins for why these are pins, not oracles)."""

    @pytest.fixture(scope="class")
    def rp(self):
        path = pathlib.Path(__file__).parent / "goldens" / "rgps_pins.npz"
        assert path.exists(), "run tests/make_goldens.py --rgps"
        return np.load(path)

    def _inputs(self, rp):
        from trajopt_jax.core.types import (
            LinearGaussianPolicy,
            MatrixNormalParams,
        )

        T = rp["in_A"].shape[0]
        pdim = rp["in_theta"].shape[-1]
        dx = rp["in_A"].shape[-1]
        nominal = MatrixNormalParams(
            mu=jnp.asarray(rp["in_theta"]),
            sigma=jnp.asarray(np.broadcast_to(1e-3 * np.eye(pdim),
                                              (T, pdim, pdim))),
        )
        du = rp["in_K"].shape[-2]
        ctl = LinearGaussianPolicy(
            K=jnp.asarray(rp["in_K"]), kff=jnp.asarray(rp["in_kff"]),
            sigma=jnp.asarray(np.broadcast_to(np.eye(du), (T, du, du))),
        )
        noise = jnp.asarray(np.broadcast_to(1e-4 * np.eye(dx), (T, dx, dx)))
        return nominal, ctl, noise, T, dx

    def test_cubature_pin(self, rp):
        from trajopt_jax.core.cubature import cubature_forward_pass

        nominal, ctl, noise, T, dx = self._inputs(rp)
        xdist, udist, _ = cubature_forward_pass(
            jnp.asarray(rp["in_mu0"]), jnp.asarray(0.01 * np.eye(dx)),
            nominal, noise, ctl,
        )
        np.testing.assert_allclose(np.asarray(xdist.mu), rp["cub_mu"],
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(xdist.sigma), rp["cub_sigma"],
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(np.asarray(udist.mu), rp["cub_umu"],
                                   rtol=1e-10, atol=1e-12)

    def test_adversary_pin(self, rp):
        from trajopt_jax.core.cubature import (
            parameter_augment_cost,
            parameter_backward_pass,
        )
        from trajopt_jax.core.types import GaussianSequence, QuadraticCost

        nominal, ctl, noise, T, dx = self._inputs(rp)
        cost = QuadraticCost(*[jnp.asarray(rp[f"in_{k}"]) for k in
                               ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0"]])
        xdist = GaussianSequence(mu=jnp.asarray(rp["cub_mu"]),
                                 sigma=jnp.asarray(rp["cub_sigma"]))
        agCpp, agcp, _ = parameter_augment_cost(nominal, jnp.asarray(100.0))
        param, _, div = parameter_backward_pass(
            xdist, ctl, noise, cost, agCpp, agcp, jnp.asarray(200.0)
        )
        assert not bool(div)
        np.testing.assert_allclose(np.asarray(param.mu), rp["adv_mu"],
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(param.sigma), rp["adv_sigma"],
                                   rtol=1e-9, atol=1e-12)

    def test_policy_pin(self, rp):
        from trajopt_jax.core.cubature import policy_backward_pass
        from trajopt_jax.core.types import QuadraticCost

        nominal, ctl, noise, T, dx = self._inputs(rp)
        cost = QuadraticCost(*[jnp.asarray(rp[f"in_{k}"]) for k in
                               ["Cxx", "cx", "Cuu", "cu", "Cxu", "c0"]])
        lgc, _, _, div = policy_backward_pass(
            cost, nominal, noise, jnp.full(T, 10.0)
        )
        assert not bool(div)
        np.testing.assert_allclose(np.asarray(lgc.K), rp["pol_K"],
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(lgc.kff), rp["pol_kff"],
                                   rtol=1e-9, atol=1e-11)
