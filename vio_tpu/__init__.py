"""vio_tpu: a visual-inertial odometry framework in JAX.

Built from scratch with the capability set of the reference
AlexGeControl/Visual-Inertial-Odometry workspace (VINS-Mono-style pipeline:
KLT frontend, IMU preintegration, sliding-window BA with marginalization,
SfM initialization, loop closing), with every hot path a jitted device
program.
"""
__version__ = "0.1.0"

import jax as _jax

# Float32 matmuls at full precision on every backend.  On an NVIDIA GPU the
# default lets XLA run float32 dots in TF32 (a 10-bit mantissa, ~3 decimal
# digits), which corrupts sub-pixel KLT registration and the visual-inertial
# alignment gates.  Layers that can afford reduced precision opt in
# explicitly.  Setting a config value starts no backend.
_jax.config.update("jax_default_matmul_precision", "highest")
