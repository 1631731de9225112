"""Setup-time device constants: cast on the host, transfer once.

``jnp.asarray(np_f64_array, f32_dtype)`` dispatches a ``convert_element_type``
op on the accelerator — one tiny XLA compile per distinct shape, re-paid
every process start — and feeding jnp arrays to numpy setup code pulls
them back to the host.  Dozens of each add up at 512^2 setup.  Every
setup-time constant should be built in numpy and moved with
:func:`device_const` — a pure transfer, no compile.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def host_const(a, dtype) -> np.ndarray:
    """Host-cast ``a`` to ``dtype`` and KEEP it on the host (numpy).

    For constants CAPTURED by closures that are later ``jax.jit``-ed
    (element matrices, stencil weights, lane masks): jit lowering bakes
    captured arrays into the module as MLIR constants, and when the
    captured array lives on the DEVICE that baking pulls it device->host
    first (``mlir.ir_constant -> array._value``).  A numpy capture is
    baked straight from host memory: no eager compile, no transfer, no
    pull.  Use :func:`device_const` instead for arrays passed as call
    ARGUMENTS (numpy args would re-transfer on every dispatch)."""
    if isinstance(a, jax.Array):
        raise TypeError(
            "host_const is for HOST setup constants; got a jax.Array "
            "(pass the numpy original instead of pulling it back)")
    return np.ascontiguousarray(np.asarray(a, jnp.dtype(dtype)))


def device_const(a, dtype) -> jax.Array:
    """Host-cast ``a`` to ``dtype`` and transfer it (no XLA compile).

    ``a`` must be host data (numpy / list / scalar) — passing a jax array
    would pull it device->host first, which is exactly the setup cost this
    helper exists to avoid (callers keep the numpy originals around)."""
    if isinstance(a, jax.Array):
        raise TypeError(
            "device_const is for HOST setup constants; got a jax.Array "
            "(pass the numpy original instead of pulling it back)")
    return jax.device_put(np.ascontiguousarray(np.asarray(a, jnp.dtype(dtype))))
