"""Support utilities: combinatorics, quadrature tables, IO, data structures.

JAX counterpart of the reference `fdaPDE/utils/` layer
(/root/reference/fdaPDE/utils.h). Compile-time C++ machinery (traits, type
erasure, expression nesting) has no analogue here — Python duck typing and JAX
tracing provide the same extension points.
"""

from . import combinatorics, io, quadrature
from .combinatorics import binomial, combinations, factorial
from .quadrature import (
    SimplexQuadrature,
    gauss_legendre_1d,
    simplex_quadrature,
    standard_fem_quadrature,
)

DOUBLE_TOLERANCE = 50 * 2.220446049250313e-16  # utils/symbols.h:163
MACHINE_EPSILON = 10 * 2.220446049250313e-16  # utils/symbols.h:164


def almost_equal(a, b, epsilon: float = DOUBLE_TOLERANCE) -> bool:
    """Scalar/array closeness test (reference utils/symbols.h:167-174).

    Absolute-OR-relative: |a-b| < eps or |a-b| < max(|a|,|b|)*eps, applied
    elementwise (arrays compare all entries, mirroring the matrix overload
    in test/src/utils/utils.h)."""
    import numpy as _np

    a = _np.asarray(a, dtype=float)
    b = _np.asarray(b, dtype=float)
    d = _np.abs(a - b)
    return bool(
        _np.all((d < epsilon) | (d < _np.maximum(_np.abs(a), _np.abs(b)) * epsilon))
    )


def log1pexp(x):
    """Numerically stable log(1 + exp(x)) (reference utils/symbols.h:179-189).

    Piecewise evaluation avoids overflow for large x and cancellation for
    very negative x; accepts scalars or arrays (jnp/np)."""
    import jax.numpy as _jnp

    x = _jnp.asarray(x)
    return _jnp.where(
        x <= -37.0,
        _jnp.exp(x),
        _jnp.where(
            x <= 18.0,
            _jnp.log1p(_jnp.exp(_jnp.minimum(x, 18.0))),
            _jnp.where(x <= 33.3, x + _jnp.exp(-x), x),
        ),
    )
