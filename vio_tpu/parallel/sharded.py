"""Multi-device sharded window BA: mesh + NamedSharding over factor blocks.

The reference's own hot-spot notes ("TODO:: use openMP" at Hessian assembly
and landmark-block inversion, reference: vins-mono/src/backend/problem.cc:
311-313,420,696) become SPMD over a device mesh
(SURVEY.md §2.5): the reprojection-factor axis ``F`` is sharded across the
``factor`` mesh axis, so per-factor Jacobians, robust weights, landmark
(inverse-depth) blocks, and the landmark Schur elimination are all local to
a shard; the reduced camera system ``JᵀWJ`` contributions meet in ONE
XLA-inserted ``psum`` (from the sharded contracting dimension of the
``Jmat.T @ WJmat`` / ``tempH @ Hpm.T`` GEMMs), which XLA hands to NCCL on
GPUs.  The damped
pose solve is replicated (it is (P,P), tiny), and back-substitution is
local again.

No hand-written collectives: shardings are declared on the inputs via
``NamedSharding`` and GSPMD partitions the jitted solver.  The mesh is one
"factor" axis over all cards: the cards of one host are joined all to all
(NVLink), so no axis order is closer than another.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import factors
from ..solver import lm, window as W


def make_mesh(n_devices: int | None = None, axis: str = "factor") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]).reshape(n), (axis,))


def state_shardings(mesh: Mesh, axis: str = "factor") -> W.WindowStates:
    """States are replicated except the landmark vector, which lives with
    its factor shard."""
    r = NamedSharding(mesh, P())
    f = NamedSharding(mesh, P(axis))
    return W.WindowStates(ext_t=r, ext_q=r, Ps=r, Qs=r, Vs=r, Bas=r, Bgs=r,
                          inv_dep=f)


def factor_shardings(mesh: Mesh, axis: str = "factor") -> W.WindowFactors:
    r = NamedSharding(mesh, P())
    f0 = NamedSharding(mesh, P(axis))           # (F, ...) leading factor axis
    imu_r = factors.ImuFactorTerms(*([r] * len(factors.ImuFactorTerms._fields)))
    return W.WindowFactors(
        imu_terms=imu_r, imu_valid=r,
        pts_i=f0, pts_j=f0, start=f0, obs_mask=f0, feat_valid=f0,
        H_prior=r, b_prior=r, err_prior=r, Jt_prior_inv=r,
        g=r, proj_sqrt_info=r)


def shard_problem(states: W.WindowStates, f: W.WindowFactors, mesh: Mesh,
                  axis: str = "factor"):
    """Device-put a window problem with factor-axis sharding.  The factor
    capacity F must divide by the mesh size."""
    ss = state_shardings(mesh, axis)
    fs = factor_shardings(mesh, axis)
    states = jax.tree.map(jax.device_put, states, ss)
    f = jax.tree.map(jax.device_put, f, fs)
    return states, f


@partial(jax.jit, static_argnames=("max_iter", "fix_ext", "loss_delta"))
def solve_window_sharded(states: W.WindowStates, f: W.WindowFactors,
                         max_iter: int = 10, fix_ext: bool = True,
                         loss_delta: float = 1.0):
    """The full LM solve; partitioning comes entirely from the input
    shardings (GSPMD).  Identical math to solver/lm.py::solve_window."""
    return lm.solve_window(states, f, max_iter=max_iter, fix_ext=fix_ext,
                           loss_delta=loss_delta)


def training_step(states, f, max_iter: int = 10):
    """One full estimator device-step at scale: LM solve of the sharded
    window (assembly + landmark Schur + reduced-system solve + state
    update). Returns the updated states and final chi²."""
    new_states, b_prior, err_prior, stats = solve_window_sharded(
        states, f, max_iter=max_iter)
    return new_states, stats["chi2"]
