"""Pure-NumPy oracle implementations of the kernel math, written as straight loops.

These mirror the *equations* of the reference's C++ kernels (cited per function) and
serve as the unit-test oracles for the JAX scan kernels, per the test strategy in
SURVEY.md §4.  Time axis is leading, matching trajopt_jax conventions.
"""

from __future__ import annotations

import numpy as np


def riccati_backward_np(Cxx, cx, Cuu, cu, Cxu, A, B, c):
    """riccati/riccati.py:100-126 (with the matmul fix at line 123)."""
    T = A.shape[0]
    dx, du = A.shape[-1], B.shape[-1]
    V = np.zeros((T + 1, dx, dx))
    v = np.zeros((T + 1, dx))
    K = np.zeros((T, du, dx))
    kff = np.zeros((T, du))

    V[T] = Cxx[T]
    v[T] = cx[T]
    for t in range(T - 1, -1, -1):
        Qxx = Cxx[t] + A[t].T @ V[t + 1] @ A[t]
        Quu = Cuu[t] + B[t].T @ V[t + 1] @ B[t]
        Qux = Cxu[t].T + B[t].T @ V[t + 1] @ A[t]
        qx = cx[t] + 2.0 * A[t].T @ V[t + 1] @ c[t] + A[t].T @ v[t + 1]
        qu = cu[t] + 2.0 * B[t].T @ V[t + 1] @ c[t] + B[t].T @ v[t + 1]

        Quu_inv = np.linalg.inv(Quu)
        K[t] = -Quu_inv @ Qux
        kff[t] = -0.5 * Quu_inv @ qu

        V[t] = Qxx + Qux.T @ K[t]
        v[t] = qx + 2.0 * Qux.T @ kff[t]
    return K, kff, V, v


def ilqr_backward_np(Cxx, cx, Cuu, cu, Cxu, A, B, lmbda, reg):
    """ilqr/src/util.cpp:83-182."""
    T = A.shape[0]
    dx, du = A.shape[-1], B.shape[-1]
    V = np.zeros((T + 1, dx, dx))
    v = np.zeros((T + 1, dx))
    K = np.zeros((T, du, dx))
    kff = np.zeros((T, du))
    dV = np.zeros(2)
    diverge = False

    V[T] = Cxx[T]
    v[T] = cx[T]
    for t in range(T - 1, -1, -1):
        Qxx = Cxx[t] + A[t].T @ V[t + 1] @ A[t]
        Quu = Cuu[t] + B[t].T @ V[t + 1] @ B[t]
        Qux = (Cxu[t] + A[t].T @ V[t + 1] @ B[t]).T
        qu = cu[t] + B[t].T @ v[t + 1]
        qx = cx[t] + A[t].T @ v[t + 1]

        V_reg = V[t + 1] + (lmbda * np.eye(dx) if reg == 2 else 0.0)
        Qux_reg = (Cxu[t] + A[t].T @ V_reg @ B[t]).T
        Quu_reg = Cuu[t] + B[t].T @ V_reg @ B[t] + (lmbda * np.eye(du) if reg == 1 else 0.0)

        # SPD check
        try:
            np.linalg.cholesky(Quu_reg)
        except np.linalg.LinAlgError:
            diverge = True
            break

        Quu_inv = np.linalg.inv(Quu_reg)
        K[t] = -Quu_inv @ Qux_reg
        kff[t] = -Quu_inv @ qu

        dV += np.array([kff[t] @ qu, 0.5 * kff[t] @ Quu @ kff[t]])

        v[t] = qx + K[t].T @ Quu @ kff[t] + K[t].T @ qu + Qux.T @ kff[t]
        V[t] = Qxx + K[t].T @ Quu @ K[t] + K[t].T @ Qux + Qux.T @ K[t]
        V[t] = 0.5 * (V[t] + V[t].T)
    return K, kff, V, v, dV, diverge


def gps_backward_np(Cxx, cx, Cuu, cu, Cxu, c0, A, B, c, sigma_dyn, alpha):
    """gps/src/util.cpp:272-374."""
    T = A.shape[0]
    dx, du = A.shape[-1], B.shape[-1]
    V = np.zeros((T + 1, dx, dx))
    v = np.zeros((T + 1, dx))
    v0 = np.zeros(T + 1)
    K = np.zeros((T, du, dx))
    kff = np.zeros((T, du))
    sigma_ctl = np.zeros((T, du, du))
    diverge = False

    V[T] = Cxx[T]
    v[T] = cx[T]
    v0[T] = c0[T]
    for t in range(T - 1, -1, -1):
        a = alpha[t]
        Qxx = -(Cxx[t] + A[t].T @ V[t + 1] @ A[t]) / a
        Quu = -(Cuu[t] + B[t].T @ V[t + 1] @ B[t]) / a
        Qux = -(Cxu[t] + A[t].T @ V[t + 1] @ B[t]).T / a
        qu = -(cu[t] + 2.0 * B[t].T @ V[t + 1] @ c[t] + B[t].T @ v[t + 1]) / a
        qx = -(cx[t] + 2.0 * A[t].T @ V[t + 1] @ c[t] + A[t].T @ v[t + 1]) / a
        q0 = -(
            c0[t] + v0[t + 1] + c[t] @ V[t + 1] @ c[t]
            + np.trace(V[t + 1] @ sigma_dyn[t]) + v[t + 1] @ c[t]
        ) / a

        # -Quu must be PD for a valid Gaussian policy
        try:
            np.linalg.cholesky(-0.5 * (Quu + Quu.T))
        except np.linalg.LinAlgError:
            diverge = True
            break

        Quu_inv = np.linalg.inv(Quu)
        K[t] = -Quu_inv @ Qux
        kff[t] = -0.5 * Quu_inv @ qu
        sigma_ctl[t] = -0.5 * Quu_inv
        sigma_ctl[t] = 0.5 * (sigma_ctl[t] + sigma_ctl[t].T)

        V[t] = -a * (Qxx + Qux.T @ K[t])
        V[t] = 0.5 * (V[t] + V[t].T)
        v[t] = -a * (qx + 2.0 * Qux.T @ kff[t])
        v0[t] = -a * (
            0.5 * qu @ kff[t] + q0
            + 0.5 * (du * np.log(2.0 * np.pi) - np.log(np.linalg.det(-2.0 * Quu)))
        )
    return K, kff, sigma_ctl, V, v, v0, diverge


def gaussian_forward_np(mu0, sigma0, A, B, c, sigma_dyn, K, kff, sigma_ctl):
    """gps/src/util.cpp:195-269."""
    T = A.shape[0]
    dx, du = A.shape[-1], B.shape[-1]
    mu_x = np.zeros((T + 1, dx))
    sigma_x = np.zeros((T + 1, dx, dx))
    mu_u = np.zeros((T, du))
    sigma_u = np.zeros((T, du, du))
    mu_xu = np.zeros((T + 1, dx + du))
    sigma_xu = np.zeros((T + 1, dx + du, dx + du))

    mu_x[0] = mu0
    sigma_x[0] = sigma0
    for t in range(T):
        mu_u[t] = K[t] @ mu_x[t] + kff[t]
        su = sigma_ctl[t] + K[t] @ sigma_x[t] @ K[t].T
        sigma_u[t] = 0.5 * (su + su.T)

        cross = sigma_x[t] @ K[t].T
        sxu = np.block([[sigma_x[t], cross], [cross.T, sigma_u[t]]])
        sigma_xu[t] = 0.5 * (sxu + sxu.T)
        mu_xu[t] = np.concatenate([mu_x[t], mu_u[t]])

        AB = np.concatenate([A[t], B[t]], axis=1)
        sxn = sigma_dyn[t] + AB @ sigma_xu[t] @ AB.T
        sigma_x[t + 1] = 0.5 * (sxn + sxn.T)
        mu_x[t + 1] = AB @ mu_xu[t] + c[t]

    mu_xu[T] = np.concatenate([mu_x[T], np.zeros(du)])
    sigma_xu[T, :dx, :dx] = sigma_x[T]
    return mu_x, sigma_x, mu_u, sigma_u, mu_xu, sigma_xu


def augment_cost_np(Cxx, cx, Cuu, cu, Cxu, c0, K, kff, sigma_ctl, alpha):
    """gps/src/util.cpp:136-193."""
    T = K.shape[0]
    agCxx, agcx = Cxx.copy(), cx.copy()
    agCuu, agcu = Cuu.copy(), cu.copy()
    agCxu, agc0 = Cxu.copy(), c0.copy()
    for t in range(T):
        lam = np.linalg.inv(sigma_ctl[t])
        a = alpha[t]
        agCxx[t] = Cxx[t] + 0.5 * a * K[t].T @ lam @ K[t]
        agCuu[t] = Cuu[t] + 0.5 * a * lam
        agCxu[t] = Cxu[t] - 0.5 * a * K[t].T @ lam
        agcx[t] = cx[t] + a * K[t].T @ lam @ kff[t]
        agcu[t] = cu[t] - a * lam @ kff[t]
        agc0[t] = c0[t] + 0.5 * a * np.log(
            np.linalg.det(2.0 * np.pi * sigma_ctl[t])
        ) + 0.5 * a * kff[t] @ lam @ kff[t]
    return agCxx, agcx, agCuu, agcu, agCxu, agc0


def kl_divergence_np(pK, pk, psig, qK, qk, qsig, mu_x, sigma_x):
    """gps/src/util.cpp:83-121."""
    T = pK.shape[0]
    du = pk.shape[-1]
    kl = np.zeros(T)
    for t in range(T):
        q_lam = np.linalg.inv(qsig[t])
        dK = qK[t] - pK[t]
        dk = pk[t] - qk[t]
        diff_K = dK.T @ q_lam @ dK
        diff_crs = dK.T @ q_lam @ dk
        diff_kff = dk @ q_lam @ dk
        kl[t] = (
            0.5 * np.log(np.linalg.det(qsig[t]) / np.linalg.det(psig[t]))
            + 0.5 * np.trace(q_lam @ psig[t])
            - 0.5 * du
            + 0.5 * np.trace(diff_K @ sigma_x[t])
            + 0.5 * mu_x[t] @ diff_K @ mu_x[t]
            - mu_x[t] @ diff_crs
            + 0.5 * diff_kff
        )
    return kl


def random_quadratic_problem(rng, T, dx, du, gaussian=False):
    """A well-conditioned random LQ problem in the absolute convention."""

    def spd(d, scale=1.0):
        M = rng.standard_normal((d, d))
        return scale * (M @ M.T + d * np.eye(d))

    A = np.stack([np.eye(dx) + 0.05 * rng.standard_normal((dx, dx)) for _ in range(T)])
    B = 0.1 * rng.standard_normal((T, dx, du))
    c = 0.01 * rng.standard_normal((T, dx))

    Cxx = np.stack([spd(dx) for _ in range(T + 1)])
    Cuu = np.stack([spd(du, 0.5) for _ in range(T + 1)])
    Cxu = 0.1 * rng.standard_normal((T + 1, dx, du))
    cx = rng.standard_normal((T + 1, dx))
    cu = rng.standard_normal((T + 1, du))
    c0 = rng.standard_normal(T + 1)

    out = dict(Cxx=Cxx, cx=cx, Cuu=Cuu, cu=cu, Cxu=Cxu, c0=c0, A=A, B=B, c=c)
    if gaussian:
        out["sigma_dyn"] = np.stack([1e-4 * spd(dx) for _ in range(T)])
    return out


def quad_pendulum_ode_np(x, u):
    """DECLARED TEST ORACLE — equation-level transcription of the reference's
    four-link closed-form dynamics (envs/quad_pendulum/quad_pendulum.py:62-228,
    itself from Atkeson's dynamics-2d / PolicySearchToolbox).  Used ONLY to pin
    trajopt_jax.envs.nlink.nlink_ode(n=4) — the shipped library code generates the
    same Euler-Lagrange equations by autodiff and shares no code with this.

    Inputs: x = (th1..th4, dth1..dth4) external coordinates (th1 = 0 upright),
    u = joint torques (4,).  Returns (dth, ddth) = the ODE right-hand side.
    """
    masses = np.array([1.0, 1.0, 1.0, 1.0])
    lengths = np.array([1.0, 1.0, 1.0, 1.0])
    friction = 0.025 * np.array([1.0, 1.0, 1.0, 1.0])
    G = 9.81
    inertias = masses * (lengths**2 + 1e-4) / 3.0

    th1, th2, th3, th4, dth1, dth2, dth3, dth4 = (float(v) for v in x)
    th1 = th1 + np.pi  # downward position = PI
    u1, u2, u3, u4 = (float(v) for v in u)

    I1, I2, I3, I4 = inertias
    l1, l2, l3, l4 = lengths
    m1, m2, m3, m4 = masses
    fr1, fr2, fr3, fr4 = friction
    l1cm, l2cm, l3cm, l4cm = l1 / 2.0, l2 / 2.0, l3 / 2.0, l4 / 2.0

    s1, c1 = np.sin(th1), np.cos(th1)
    s2, c2 = np.sin(th2), np.cos(th2)
    s3, c3 = np.sin(th3), np.cos(th3)
    s4, c4 = np.sin(th4), np.cos(th4)

    s12 = s1 * c2 + c1 * s2
    c12 = c1 * c2 - s1 * s2
    s23 = s2 * c3 + c2 * s3
    c23 = c2 * c3 - s2 * s3
    s34 = s3 * c4 + c3 * s4
    c34 = c3 * c4 - s3 * s4

    s1234 = s12 * c34 + c12 * s34
    s123 = s12 * c3 + c12 * s3
    s234 = s2 * c34 + c2 * s34
    c234 = c2 * c34 - s2 * s34

    dth1_dth1 = dth1 * dth1
    dth2_dth2 = dth2 * dth2
    dth3_dth3 = dth3 * dth3
    dth4_dth4 = dth4 * dth4
    dth1_p_dth2_2 = (dth1 + dth2) * (dth1 + dth2)

    l4cm_m4 = l4cm * m4
    l3_l4cm_m4 = l3 * l4cm_m4
    l2_l4cm_m4 = l2 * l4cm_m4
    l2_l4cm_m4_c34 = l2_l4cm_m4 * c34
    l1_l4cm_m4 = l1 * l4cm_m4
    l3_m4 = l3 * m4
    l3cm_m3 = l3cm * m3
    l3cm_m3_l3_m4 = l3cm_m3 + l3_m4
    l2cm_m2 = l2cm * m2
    l2cm_m2_p_l2_m3_p_m4 = l2cm_m2 + l2 * (m3 + m4)
    l2_l3cm_m3_l3_m4 = l2 * l3cm_m3_l3_m4
    l1_l3cm_m3_l3_m4 = l1 * l3cm_m3_l3_m4
    a123d = dth1 + dth2 + dth3
    l1_l3cm_m3_l3_m4_s23 = l1_l3cm_m3_l3_m4 * s23
    l2_l4cm_m4_s34 = l2_l4cm_m4 * s34

    expr1 = G * (s123 * l3cm_m3_l3_m4 + s1234 * l4cm_m4)
    expr2 = (2 * a123d + dth4) * dth4 * l3_l4cm_m4 * s4
    expr3 = G * l2cm_m2_p_l2_m3_p_m4 * s12
    expr4a = 2 * dth1 * dth4 + 2 * dth2 * dth4 + 2 * dth3 * dth4 + dth4_dth4
    expr4b = 2 * dth1 * dth3 + 2 * dth2 * dth3 + dth3_dth3
    expr4 = (expr4b + expr4a) * l2_l4cm_m4_s34
    expr5a = dth1_dth1 * l1 * s234
    expr5 = l4cm_m4 * expr5a
    expr6 = expr4b * l2_l3cm_m3_l3_m4 * s3
    expr7 = l1 * l2cm_m2_p_l2_m3_p_m4
    expr8 = l1 * (m2 + m3 + m4)
    expr9a = 2 * dth1 * dth2 + dth2_dth2
    expr9 = expr9a + expr4b

    p = I4 + l4cm * l4cm_m4
    o = p + l3_l4cm_m4 * c4
    n = o + l2_l4cm_m4_c34
    m = n + l1_l4cm_m4 * c234

    t = u4 - fr4 * dth4 - (
        l4cm_m4 * (a123d * a123d * l3 * s4 + dth1_p_dth2_2 * l2 * s34
                   + expr5a + G * s1234)
    )

    l = o
    k = I3 + o + l3cm * l3cm_m3 + l3 * l3_m4 + l3_l4cm_m4 * c4
    j = k + l2_l3cm_m3_l3_m4 * c3 + l2_l4cm_m4_c34
    i = j + l1_l3cm_m3_l3_m4 * c23 + l1_l4cm_m4 * c234

    s = u3 - fr3 * dth3 - (
        (dth1_p_dth2_2 * l2_l3cm_m3_l3_m4 * s3 + dth1_dth1 * l1_l3cm_m3_l3_m4_s23)
        - expr2 + dth1_p_dth2_2 * l2_l4cm_m4_s34 + expr5 + expr1
    )

    h = n
    g = j

    f = j + I2 + l2cm * l2cm_m2 + (l2 * l2) * (m3 + m4) \
        + l2_l3cm_m3_l3_m4 * c3 + l2_l4cm_m4_c34

    e = f + i - j + expr7 * c2

    r = u2 - fr2 * dth2 - (
        dth1_dth1 * expr7 * s2 - expr6 + dth1_dth1 * l1_l3cm_m3_l3_m4_s23
        - expr2 - expr4 + expr5 + expr3 + expr1
    )

    d = m
    c = i
    b = e
    a = 2 * e + I1 - f + (l1cm * l1cm) * m1 + l1 * expr8

    q = u1 - fr1 * dth1 - (
        -expr9a * expr7 * s2 - expr6 - expr9 * l1_l3cm_m3_l3_m4_s23
        - expr2 - expr4 - (expr9 + expr4a) * l1_l4cm_m4 * s234
        + expr3 + G * (l1cm * m1 + expr8) * s1 + expr1
    )

    det = (d * g * j * m - c * h * j * m - d * f * k * m + b * h * k * m
           + c * f * l * m - b * g * l * m - d * g * i * n + c * h * i * n
           + d * e * k * n - a * h * k * n - c * e * l * n + a * g * l * n
           + d * f * i * o - b * h * i * o - d * e * j * o + a * h * j * o
           + b * e * l * o - a * f * l * o - c * f * i * p + b * g * i * p
           + c * e * j * p - a * g * j * p - b * e * k * p + a * f * k * p)

    ddth1 = (q * (-(h * k * n) + g * l * n + h * j * o - f * l * o - g * j * p + f * k * p)
             + r * (d * k * n - c * l * n - d * j * o + b * l * o + c * j * p - b * k * p)
             + s * (-(d * g * n) + c * h * n + d * f * o - b * h * o - c * f * p + b * g * p)
             + t * (d * g * j - c * h * j - d * f * k + b * h * k + c * f * l - b * g * l))

    ddth2 = (q * (h * k * m - g * l * m - h * i * o + e * l * o + g * i * p - e * k * p)
             + r * (-(d * k * m) + c * l * m + d * i * o - a * l * o - c * i * p + a * k * p)
             + s * (d * g * m - c * h * m - d * e * o + a * h * o + c * e * p - a * g * p)
             + t * (-(d * g * i) + c * h * i + d * e * k - a * h * k - c * e * l + a * g * l))

    ddth3 = (q * (-(h * j * m) + f * l * m + h * i * n - e * l * n - f * i * p + e * j * p)
             + r * (d * j * m - b * l * m - d * i * n + a * l * n + b * i * p - a * j * p)
             + s * (-(d * f * m) + b * h * m + d * e * n - a * h * n - b * e * p + a * f * p)
             + t * (d * f * i - b * h * i - d * e * j + a * h * j + b * e * l - a * f * l))

    ddth4 = (q * (g * j * m - f * k * m - g * i * n + e * k * n + f * i * o - e * j * o)
             + r * (-(c * j * m) + b * k * m + c * i * n - a * k * n - b * i * o + a * j * o)
             + s * (c * f * m - b * g * m - c * e * n + a * g * n + b * e * o - a * f * o)
             + t * (-(c * f * i) + b * g * i + c * e * j - a * g * j - b * e * k + a * f * k))

    return np.array([dth1, dth2, dth3, dth4,
                     ddth1 / det, ddth2 / det, ddth3 / det, ddth4 / det])
