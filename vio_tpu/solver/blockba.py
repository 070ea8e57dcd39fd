"""Generic camera-point block bundle-adjustment engine.

The shared machinery behind BAL BA (solver/bal.py) and photometric direct
BA (features/direct.py): per-observation residual/Jacobian batches are
scatter-added with ``segment_sum`` into block normal equations — dense
camera Hessian (DC*C, DC*C), batched 3x3 point blocks, and a dense
(C, M, DC, 3) coupling tensor — then the point blocks are Schur-eliminated
and the damped reduced camera system solved (ops/linsolve.spd_solve).
A host-side Nielsen-LM drives it (these BAs run once, not per
frame; per-step work is jitted device code).

This is the batched answer to the reference's per-edge g2o/hand-written
Hessian accumulation (reference: 07-backend-optimization/01-bal-g2o/src/
bal_g2o.cpp and 02-direct-ba/direct_ba.cpp; block solve structure as in
vins-mono/src/backend/problem.cc:394-451).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linsolve


class BlockNormal(NamedTuple):
    Hcc: jnp.ndarray   # (DC*C, DC*C)
    bc: jnp.ndarray    # (DC*C,)
    Hpp: jnp.ndarray   # (M, 3, 3)
    bp: jnp.ndarray    # (M, 3)
    Wcp: jnp.ndarray   # (C, M, DC, 3)
    chi2: jnp.ndarray  # ()


def assemble_blocks(r, Jc, Jp, cam_idx, pt_idx, w, rho, C: int, M: int,
                    fixed_diag=None) -> BlockNormal:
    """Build block normal equations from per-observation batches.

    r (O, R) residuals; Jc (O, R, DC), Jp (O, R, 3) Jacobians (already
    zeroed for fixed cameras); w (O,) combined validity+robust weight;
    rho (O,) robust chi contribution.  fixed_diag: optional (DC*C,) vector
    added to the camera diagonal (1.0 on fixed/disabled parameters keeps
    the reduced system SPD)."""
    DC = Jc.shape[-1]
    dtype = r.dtype
    Jc_w = Jc * w[:, None, None]
    rw = r * w[:, None]

    Hcc_blk = jnp.einsum("ori,orj->oij", Jc_w, Jc)                # (O,DC,DC)
    bc_blk = -jnp.einsum("ori,or->oi", Jc, rw)                    # (O,DC)
    Hcc_d = jax.ops.segment_sum(Hcc_blk, cam_idx, num_segments=C)
    bc_d = jax.ops.segment_sum(bc_blk, cam_idx, num_segments=C)
    Hcc = jnp.zeros((C, C, DC, DC), dtype).at[
        jnp.arange(C), jnp.arange(C)].set(Hcc_d)
    Hcc = Hcc.transpose(0, 2, 1, 3).reshape(DC * C, DC * C)
    bc = bc_d.reshape(DC * C)
    if fixed_diag is not None:
        Hcc = Hcc + jnp.diag(fixed_diag)

    Hpp_blk = jnp.einsum("ori,orj->oij", Jp * w[:, None, None], Jp)
    bp_blk = -jnp.einsum("ori,or->oi", Jp, rw)
    Hpp = jax.ops.segment_sum(Hpp_blk, pt_idx, num_segments=M)
    bp = jax.ops.segment_sum(bp_blk, pt_idx, num_segments=M)

    Wblk = jnp.einsum("ori,orj->oij", Jc_w, Jp)                   # (O,DC,3)
    flat = cam_idx.astype(jnp.int32) * M + pt_idx.astype(jnp.int32)
    Wcp = jax.ops.segment_sum(Wblk, flat, num_segments=C * M)
    Wcp = Wcp.reshape(C, M, DC, 3)
    chi2 = 0.5 * jnp.sum(rho)
    return BlockNormal(Hcc=Hcc, bc=bc, Hpp=Hpp, bp=bp, Wcp=Wcp, chi2=chi2)


def schur_solve(n: BlockNormal, lam, C: int, M: int):
    """Point-block Schur elimination -> damped reduced camera solve ->
    back-substitution.  Returns (dxc (C, DC), dxp (M, 3))."""
    DC = n.Wcp.shape[2]
    dtype = n.bc.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    Hpp_d = n.Hpp + lam * eye3[None]
    Hpp_inv = jnp.linalg.inv(Hpp_d + 1e-12 * eye3[None])          # (M,3,3)
    WHinv = jnp.einsum("cmij,mjk->cmik", n.Wcp, Hpp_inv)          # (C,M,DC,3)
    S = (n.Hcc + lam * jnp.eye(DC * C, dtype=dtype)
         - jnp.einsum("cmik,dmjk->cidj", WHinv, n.Wcp).reshape(DC * C, DC * C))
    rhs = n.bc - jnp.einsum("cmik,mk->ci", WHinv, n.bp).reshape(DC * C)
    dxc = linsolve.spd_solve(S, rhs)
    dxc_b = dxc.reshape(C, DC)
    rp = n.bp - jnp.einsum("cmik,ci->mk", n.Wcp, dxc_b)
    dxp = jnp.einsum("mij,mj->mi", Hpp_inv, rp)
    return dxc_b, dxp


def lm_loop(p0, assemble_fn: Callable, apply_fn: Callable, C: int, M: int,
            max_iter: int = 30, lam0_scale: float = 1e-4,
            verbose: bool = False):
    """Host-side Nielsen LM over the block-Schur system.

    assemble_fn(p) -> BlockNormal; apply_fn(p, dxc, dxp) -> p."""
    p = p0
    n = assemble_fn(p)
    lam = lam0_scale * float(jnp.max(jnp.abs(jnp.diagonal(n.Hcc))))
    ni = 2.0
    chi = float(n.chi2)
    history = [chi]
    for _ in range(max_iter):
        dxc, dxp = schur_solve(n, jnp.asarray(lam, n.bc.dtype), C, M)
        cand = apply_fn(p, dxc, dxp)
        n_cand = assemble_fn(cand)
        chi_cand = float(n_cand.chi2)
        dx = jnp.concatenate([dxc.reshape(-1), dxp.reshape(-1)])
        b = jnp.concatenate([n.bc, n.bp.reshape(-1)])
        scale = 0.5 * float(jnp.dot(dx, lam * dx + b)) + 1e-12
        rho = (chi - chi_cand) / scale
        if rho > 0 and np.isfinite(chi_cand):
            alpha = min(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
            lam *= max(1.0 / 3.0, alpha)
            ni = 2.0
            stop = (chi - chi_cand) < 1e-8 * max(chi, 1.0)
            p, n, chi = cand, n_cand, chi_cand
            history.append(chi)
            if verbose:
                print(f"iter chi2={chi:.6e} lam={lam:.3e}")
            if stop:
                break
        else:
            lam *= ni
            ni *= 2.0
            if lam > 1e16:
                break
    return p, history
