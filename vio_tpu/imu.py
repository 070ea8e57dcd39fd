"""IMU preintegration: midpoint integrator with bias Jacobian & covariance.

Re-derivation in JAX of the reference's IntegrationBase
(reference: vins-mono/include/factor/integration_base.h:54-128
midPointIntegration, :130-158 propagate, :160-186 evaluate).  The whole
buffer is integrated in one masked ``lax.scan``; repropagation after a bias
update is just another call with new linearization biases — no mutable
state.  Batched over window slots with ``jax.vmap``.

State ordering (15): [p(0:3), theta(3:6), v(6:9), ba(9:12), bg(12:15)]
(reference: parameters.h O_P/O_R/O_V/O_BA/O_BG).
Noise ordering (18): [an0, gn0, an1, gn1, baw, bgw].
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .utils import lie


class PreintState(NamedTuple):
    delta_p: jnp.ndarray       # (..., 3)
    delta_q: jnp.ndarray       # (..., 4) x,y,z,w
    delta_v: jnp.ndarray       # (..., 3)
    jacobian: jnp.ndarray      # (..., 15, 15)  d(preint)/d(bias at start)
    covariance: jnp.ndarray    # (..., 15, 15)
    sum_dt: jnp.ndarray        # (...)
    linearized_ba: jnp.ndarray # (..., 3)
    linearized_bg: jnp.ndarray # (..., 3)
    acc_last: jnp.ndarray      # (..., 3) previous accel sample (acc_0)
    gyr_last: jnp.ndarray      # (..., 3)


def init_state(acc0, gyr0, ba, bg, dtype=None) -> PreintState:
    """Fresh preintegration anchored at measurement (acc0, gyr0) with
    linearization biases (ba, bg) (reference ctor integration_base.h:13-28)."""
    dtype = dtype or jnp.result_type(acc0)
    z3 = jnp.zeros(3, dtype)
    return PreintState(
        delta_p=z3,
        delta_q=lie.quat_identity(dtype),
        delta_v=z3,
        jacobian=jnp.eye(15, dtype=dtype),
        covariance=jnp.zeros((15, 15), dtype),
        sum_dt=jnp.zeros((), dtype),
        linearized_ba=jnp.asarray(ba, dtype),
        linearized_bg=jnp.asarray(bg, dtype),
        acc_last=jnp.asarray(acc0, dtype),
        gyr_last=jnp.asarray(gyr0, dtype),
    )


def noise_diag(acc_n, gyr_n, acc_w, gyr_w, dtype=None):
    """Diagonal of the 18x18 continuous noise covariance
    (reference integration_base.h:21-27)."""
    an = acc_n * acc_n
    gn = gyr_n * gyr_n
    aw = acc_w * acc_w
    gw = gyr_w * gyr_w
    return jnp.array([an] * 3 + [gn] * 3 + [an] * 3 + [gn] * 3 + [aw] * 3 + [gw] * 3,
                     dtype=dtype or jnp.result_type(float))


def midpoint_step(state: PreintState, dt, acc1, gyr1, noise_d,
                  X=None):
    """One midpoint integration step (integration_base.h:54-128).
    Returns (new_state, X_next); pass X (15, 18) to propagate the exact
    shared-boundary-sample noise correlation (see inline note), or None
    for the reference's independent-noise approximation."""
    dtype = state.delta_p.dtype
    acc0, gyr0 = state.acc_last, state.gyr_last
    ba, bg = state.linearized_ba, state.linearized_bg

    un_acc_0 = lie.quat_rotate(state.delta_q, acc0 - ba)
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq = jnp.concatenate([un_gyr * (dt / 2.0), jnp.ones((1,), dtype)])
    result_q = lie.quat_normalize(lie.quat_mul(state.delta_q, dq))
    un_acc_1 = lie.quat_rotate(result_q, acc1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    result_p = state.delta_p + state.delta_v * dt + 0.5 * un_acc * dt * dt
    result_v = state.delta_v + un_acc * dt

    # --- discrete transition F (15x15) and noise map V (15x18) ---
    R0 = lie.quat_to_mat(state.delta_q)
    R1 = lie.quat_to_mat(result_q)
    w_x = lie.so3_hat(un_gyr)
    a0_x = lie.so3_hat(acc0 - ba)
    a1_x = lie.so3_hat(acc1 - ba)
    I3 = jnp.eye(3, dtype=dtype)
    dt2 = dt * dt
    R1a1 = R1 @ a1_x
    ImWdt = I3 - w_x * dt

    F = jnp.zeros((15, 15), dtype)
    F = F.at[0:3, 0:3].set(I3)
    F = F.at[0:3, 3:6].set(-0.25 * (R0 @ a0_x) * dt2 - 0.25 * (R1a1 @ ImWdt) * dt2)
    F = F.at[0:3, 6:9].set(I3 * dt)
    F = F.at[0:3, 9:12].set(-0.25 * (R0 + R1) * dt2)
    F = F.at[0:3, 12:15].set(0.25 * R1a1 * dt2 * dt)
    F = F.at[3:6, 3:6].set(ImWdt)
    F = F.at[3:6, 12:15].set(-I3 * dt)
    F = F.at[6:9, 3:6].set(-0.5 * (R0 @ a0_x) * dt - 0.5 * (R1a1 @ ImWdt) * dt)
    F = F.at[6:9, 6:9].set(I3)
    F = F.at[6:9, 9:12].set(-0.5 * (R0 + R1) * dt)
    F = F.at[6:9, 12:15].set(0.5 * R1a1 * dt2)
    F = F.at[9:12, 9:12].set(I3)
    F = F.at[12:15, 12:15].set(I3)

    V = jnp.zeros((15, 18), dtype)
    V = V.at[0:3, 0:3].set(0.25 * R0 * dt2)
    v03 = -0.125 * R1a1 * dt2 * dt  # 0.25 * (-R1 a1x) * dt² * 0.5dt
    V = V.at[0:3, 3:6].set(v03)
    V = V.at[0:3, 6:9].set(0.25 * R1 * dt2)
    V = V.at[0:3, 9:12].set(v03)
    V = V.at[3:6, 3:6].set(0.5 * I3 * dt)
    V = V.at[3:6, 9:12].set(0.5 * I3 * dt)
    V = V.at[6:9, 0:3].set(0.5 * R0 * dt)
    v63 = -0.25 * R1a1 * dt2  # 0.5 * (-R1 a1x) * dt * 0.5dt
    V = V.at[6:9, 3:6].set(v63)
    V = V.at[6:9, 6:9].set(0.5 * R1 * dt)
    V = V.at[6:9, 9:12].set(v63)
    V = V.at[9:12, 12:15].set(I3 * dt)
    V = V.at[12:15, 15:18].set(I3 * dt)

    jac = F @ state.jacobian
    cov = F @ state.covariance @ F.T + (V * noise_d[None, :]) @ V.T

    # --- shared-sample noise correlation (exact discrete model) ---
    # Consecutive midpoint steps SHARE the boundary IMU sample: step k's
    # (acc1, gyr1) IS step k+1's (acc0, gyr0).  The reference treats the
    # 18-dim step noises as independent (integration_base.h:54-128), which
    # understates the white-noise covariance of the preintegrated state by
    # up to ~2x (each sample enters two half-weighted steps) and makes the
    # estimator IMU-overconfident at matched priors.  X carries
    # cov(delta_x_k, w_k) = V_{k-1} · cov(w_{k-1}, w_k); the recursion
    # adds the exact cross terms F X Vᵀ + V Xᵀ Fᵀ.
    if X is not None:
        cross = (F @ X) @ V.T
        cov = cov + cross + cross.T
        an = noise_d[0]
        gn = noise_d[3]
        X_next = jnp.zeros_like(X)
        X_next = X_next.at[:, 0:3].set(V[:, 6:9] * an)
        X_next = X_next.at[:, 3:6].set(V[:, 9:12] * gn)
    else:
        X_next = None

    return PreintState(
        delta_p=result_p, delta_q=result_q, delta_v=result_v,
        jacobian=jac, covariance=cov,
        sum_dt=state.sum_dt + dt,
        linearized_ba=ba, linearized_bg=bg,
        acc_last=acc1, gyr_last=gyr1,
    ), X_next


def preintegrate(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                 exact_noise: bool = True) -> PreintState:
    """Integrate a fixed-capacity buffer of IMU samples in one lax.scan.

    dts (M,), accs (M,3), gyrs (M,3), mask (M,) bool — masked-out steps are
    no-ops (identity carry), giving static shapes for jit.  Equivalent to
    repeated IntegrationBase::push_back / repropagate
    (integration_base.h:30-52).  exact_noise: propagate the
    shared-boundary-sample noise correlation (config.imu_noise_model)."""
    state = init_state(acc0, gyr0, ba, bg, dtype=jnp.result_type(accs))
    X0 = (jnp.zeros((15, 18), state.delta_p.dtype) if exact_noise else None)

    def step(carry, inp):
        st, X = carry
        dt, acc, gyr, m = inp
        new, X_new = midpoint_step(st, dt, acc, gyr, noise_d, X=X)
        out = jax.tree.map(lambda a, b: jnp.where(m, a, b), new, st)
        X_out = jnp.where(m, X_new, X) if exact_noise else None
        return (out, X_out), None

    (final, _), _ = jax.lax.scan(step, (state, X0), (dts, accs, gyrs, mask))
    return final


def evaluate(state: PreintState, g,
             Pi, Qi, Vi, Bai, Bgi,
             Pj, Qj, Vj, Baj, Bgj):
    """15-dim IMU factor residual with first-order bias correction
    (reference integration_base.h:160-186 evaluate)."""
    J = state.jacobian
    dp_dba = J[0:3, 9:12]
    dp_dbg = J[0:3, 12:15]
    dq_dbg = J[3:6, 12:15]
    dv_dba = J[6:9, 9:12]
    dv_dbg = J[6:9, 12:15]

    dba = Bai - state.linearized_ba
    dbg = Bgi - state.linearized_bg

    corrected_q = lie.quat_mul(state.delta_q, lie.delta_q(dq_dbg @ dbg))
    corrected_v = state.delta_v + dv_dba @ dba + dv_dbg @ dbg
    corrected_p = state.delta_p + dp_dba @ dba + dp_dbg @ dbg

    sdt = state.sum_dt
    Qi_inv = lie.quat_conj(Qi)
    r_p = lie.quat_rotate(Qi_inv, 0.5 * g * sdt * sdt + Pj - Pi - Vi * sdt) - corrected_p
    r_q = 2.0 * lie.quat_mul(lie.quat_conj(corrected_q),
                             lie.quat_mul(Qi_inv, Qj))[:3]
    r_v = lie.quat_rotate(Qi_inv, g * sdt + Vj - Vi) - corrected_v
    return jnp.concatenate([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi])


# Batched preintegration over window slots: (W, M) buffers -> batched state.
# Jitted: the bare-vmap version dispatches an eagerly-compiled scan on every
# call, and the repeated XLA:CPU compile churn has produced segfaults in
# long-lived processes; one jitted executable per shape is also simply faster.
_preintegrate_batch = jax.jit(
    jax.vmap(preintegrate, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, None)),
    static_argnums=(9,))


def preintegrate_batch(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                       exact_noise: bool = True) -> PreintState:
    # vmap requires every positional arg to appear; default exact_noise here
    # so callers match preintegrate's signature.
    return _preintegrate_batch(dts, accs, gyrs, mask, acc0, gyr0, ba, bg,
                               noise_d, exact_noise)
