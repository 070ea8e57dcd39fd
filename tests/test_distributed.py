"""Multi-process distributed solve: 2 OS processes x 2 virtual CPU devices
under ``jax.distributed.initialize`` (Gloo collectives) — the framework's
multi-host path (SURVEY.md §5.8: jax.distributed + mesh axes ("map",
"factor")).  The reference is single-process (System.cpp pthreads only);
this is the multi-host capability BASELINE.md's 2-host scaling row asks
for, exercised on one machine.

Each process owns the host-local shards of the observation arrays
(``jax.make_array_from_callback``), the mesh spans both processes with
"map" as the outer (cross-process) axis, and the solved trajectory
must match the single-process solver exactly.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

WORKER = r"""
import os, sys
pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from vio_tpu import testing
from vio_tpu.parallel import global_ba

assert jax.process_count() == 2
assert len(jax.devices()) == 4, jax.devices()

# identical deterministic problem in every process
gt, _ = testing.make_global_problem(N=16, M=64, obs_per_lm=4,
                                    dtype=jnp.float32)
noisy = testing.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)
# landmark-aligned observation shards (deterministic host-side prep,
# identical in every process)
noisy_np = jax.tree.map(np.asarray, global_ba.align_by_landmark(noisy, 4))

# single-process reference on this process's first local device
ref, s1 = global_ba.solve(noisy, max_iter=6, fix_frames=2)
ref_Ps = np.asarray(ref.Ps)

# global mesh across both processes: map = cross-process
mesh = global_ba.make_mesh_2d(2, 2)
rep = NamedSharding(mesh, P())
obs = NamedSharding(mesh, P(("map", "factor")))
sh = global_ba.GlobalBA(Ps=rep, Qs=rep, inv_dep=obs, host=obs,
                        bearing0=obs, lm_valid=obs, lm_idx=obs, frame=obs,
                        bearing=obs, valid=obs, sqrt_info=rep)

def globalize(x, s):
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, s, lambda idx: x[idx])

p_global = jax.tree.map(globalize, noisy_np, sh)
out, s2 = global_ba.solve_sharded(p_global, mesh, max_iter=6, fix_frames=2)
from jax.experimental import multihost_utils
out_Ps = np.asarray(multihost_utils.process_allgather(out.Ps, tiled=True))
if out_Ps.shape != ref_Ps.shape:          # gathered a replicated copy per host
    out_Ps = out_Ps.reshape((-1,) + ref_Ps.shape)[0]
err = np.abs(out_Ps - ref_Ps).max()
assert err < 1e-4, err
print(f"DIST_OK pid={pid} err={err}", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_global_ba():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(pid), port],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"stdout:{out[-800:]}\nstderr:{err[-1500:]}"
        assert "DIST_OK" in out
