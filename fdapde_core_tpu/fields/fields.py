"""Field types: callables R^M -> R / R^N / R^(NxK) with algebra and calculus.

Mirrors the behavior of the reference field layer:

- `ScalarField` wraps any callable; arithmetic (+, -, *, /), composition with
  jnp math, and lazy derivatives (`derive`, `derive_twice`),
  scalar_field.h:29-132, scalar_expressions.h:57-186,
- derivatives: `jax.grad` / `jax.hessian` when `mode="auto"`; central finite
  differences with the reference's formulas and default step h=1e-3 when
  `mode="fd"` (field_derivatives.h:44-51 first order, :66-93 second order),
- `DifferentiableScalarField` / `TwiceDifferentiableScalarField` let the user
  supply analytic gradients/hessians overriding the numeric path
  (differentiable_field.h:35-78),
- `VectorField` is a vector of scalar fields with `.dot()`
  (vector_field.h:34-92, dot_product.h:28-84), `MatrixField` a grid
  (matrix_field.h:34).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "ScalarField",
    "VectorField",
    "MatrixField",
    "DifferentiableScalarField",
    "TwiceDifferentiableScalarField",
    "DiscretizedField",
    "sin",
    "cos",
    "tan",
    "exp",
    "log",
    "sqrt",
]


def _lift(value):
    if isinstance(value, ScalarField):
        return value.f
    if callable(value):
        return value
    return lambda x: value


class ScalarField:
    """A field R^M -> R."""

    def __init__(self, f: Callable, step: float = 1e-3):
        self.f = f
        self.step = step  # FD step (scalar_expressions.h:60)

    def __call__(self, x):
        return self.f(jnp.asarray(x))

    # -- algebra (scalar_expressions.h binop nodes) ---------------------------
    def _binop(self, other, op):
        g = _lift(other)
        return ScalarField(lambda x: op(self.f(x), g(x)), self.step)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binop(other, lambda a, b: b / a)

    def __neg__(self):
        return ScalarField(lambda x: -self.f(x), self.step)

    # -- calculus -------------------------------------------------------------
    def derive(self, mode: str = "auto") -> "VectorField":
        """Gradient field (scalar_expressions.h:81, field_derivatives.h:35-54)."""
        if mode == "auto":
            return VectorField.from_callable(jax.grad(self.f))
        h = self.step

        def fd_grad(x):
            x = jnp.asarray(x, dtype=jnp.result_type(float))
            n = x.shape[0]
            eye = jnp.eye(n, dtype=x.dtype)
            plus = jnp.array([self.f(x + h * eye[i]) for i in range(n)])
            minus = jnp.array([self.f(x - h * eye[i]) for i in range(n)])
            return (plus - minus) / (2 * h)  # field_derivatives.h:44-51

        return VectorField.from_callable(fd_grad)

    def derive_twice(self, mode: str = "auto") -> "MatrixField":
        """Hessian field (scalar_expressions.h:82, field_derivatives.h:56-111)."""
        if mode == "auto":
            return MatrixField.from_callable(jax.hessian(self.f))
        h = self.step
        f = self.f

        def fd_hess(x):
            x = jnp.asarray(x, dtype=jnp.result_type(float))
            n = x.shape[0]
            eye = jnp.eye(n, dtype=x.dtype)
            rows = []
            for i in range(n):
                row = []
                for j in range(n):
                    if i == j:
                        # 5-point pure second derivative (field_derivatives.h:66-77)
                        v = (
                            -f(x + 2 * h * eye[i])
                            + 16 * f(x + h * eye[i])
                            - 30 * f(x)
                            + 16 * f(x - h * eye[i])
                            - f(x - 2 * h * eye[i])
                        ) / (12 * h * h)
                    else:
                        # 4-point mixed derivative (field_derivatives.h:79-93)
                        v = (
                            f(x + h * (eye[i] + eye[j]))
                            - f(x + h * (eye[i] - eye[j]))
                            - f(x - h * (eye[i] - eye[j]))
                            + f(x - h * (eye[i] + eye[j]))
                        ) / (4 * h * h)
                    row.append(v)
                rows.append(jnp.stack(row))
            return jnp.stack(rows)

        return MatrixField.from_callable(fd_hess)


class DifferentiableScalarField(ScalarField):
    """Scalar field with user-supplied analytic gradient
    (differentiable_field.h:35-53)."""

    def __init__(self, f, grad, step: float = 1e-3):
        super().__init__(f, step)
        self._grad = grad

    def derive(self, mode: str = "auto") -> "VectorField":
        return VectorField.from_callable(_lift(self._grad))


class TwiceDifferentiableScalarField(DifferentiableScalarField):
    """... plus analytic hessian (differentiable_field.h:55-78)."""

    def __init__(self, f, grad, hessian, step: float = 1e-3):
        super().__init__(f, grad, step)
        self._hess = hessian

    def derive_twice(self, mode: str = "auto") -> "MatrixField":
        return MatrixField.from_callable(_lift(self._hess))


class DiscretizedField:
    """A field known only at quadrature nodes, indexed `nq * cell + q`.

    Counterpart of DiscretizedScalarField / DiscretizedVectorField /
    DiscretizedMatrixField (fields/scalar_expressions.h:98-108,
    vector_expressions.h:103, matrix_expressions.h:191): the reference
    smuggles the quadrature index through a `forward(i)` side-channel so
    expression templates can read tabulated coefficient values during
    assembly. Here the assembler consumes such fields directly
    as arrays shaped (n_cells * n_quad, ...) — this wrapper only carries the
    array plus its value rank for validation and API parity
    (pde/operators.py coefficient protocol).
    """

    def __init__(self, values, rank: int = 0):
        import numpy as np

        self.values = np.asarray(values, dtype=np.float64)
        self.rank = rank  # 0: scalar, 1: vector, 2: matrix coefficient

    def __array__(self, dtype=None, copy=None):
        return self.values if dtype is None else self.values.astype(dtype)

    def forward(self, i: int):
        """Value at global quadrature index i (scalar_expressions.h:105)."""
        return self.values[i]


class VectorField:
    """A field R^M -> R^N (vector_field.h:34)."""

    def __init__(self, components):
        self.components = [c if isinstance(c, ScalarField) else ScalarField(c) for c in components]

    @classmethod
    def from_callable(cls, f):
        obj = cls.__new__(cls)
        obj.components = None
        obj._f = f
        return obj

    def __call__(self, x):
        x = jnp.asarray(x)
        if self.components is None:
            return self._f(x)
        return jnp.stack([c(x) for c in self.components])

    def __getitem__(self, i):
        if self.components is not None:
            return self.components[i]
        return ScalarField(lambda x, i=i: self(x)[i])

    def dot(self, other) -> ScalarField:
        """Lazy inner product (dot_product.h:28-84)."""
        if isinstance(other, VectorField):
            return ScalarField(lambda x: jnp.vdot(self(x), other(x)))
        v = jnp.asarray(other)
        return ScalarField(lambda x: jnp.vdot(self(x), v))

    def __add__(self, other):
        return VectorField.from_callable(lambda x: self(x) + other(x))

    def __sub__(self, other):
        return VectorField.from_callable(lambda x: self(x) - other(x))

    def __neg__(self):
        return VectorField.from_callable(lambda x: -self(x))

    def __mul__(self, s):
        if isinstance(s, ScalarField):
            return VectorField.from_callable(lambda x: self(x) * s(x))
        return VectorField.from_callable(lambda x: self(x) * s)

    __rmul__ = __mul__


class MatrixField:
    """A field R^M -> R^(NxK) (matrix_field.h:34)."""

    def __init__(self, grid):
        self.grid = [
            [c if isinstance(c, ScalarField) else ScalarField(c) for c in row]
            for row in grid
        ]

    @classmethod
    def from_callable(cls, f):
        obj = cls.__new__(cls)
        obj.grid = None
        obj._f = f
        return obj

    def __call__(self, x):
        x = jnp.asarray(x)
        if self.grid is None:
            return self._f(x)
        return jnp.stack([jnp.stack([c(x) for c in row]) for row in self.grid])

    def __getitem__(self, ij):
        i, j = ij
        if self.grid is not None:
            return self.grid[i][j]
        return ScalarField(lambda x: self(x)[i, j])

    def matvec(self, v) -> VectorField:
        """Lazy matrix-vector product -> VectorField
        (matrix_expressions.h:59 MatrixVectorProduct)."""
        if isinstance(v, VectorField):
            return VectorField.from_callable(lambda x: self(x) @ v(x))
        vv = jnp.asarray(v)
        return VectorField.from_callable(lambda x: self(x) @ vv)

    def __add__(self, other):
        return MatrixField.from_callable(lambda x: self(x) + other(x))

    def __sub__(self, other):
        return MatrixField.from_callable(lambda x: self(x) - other(x))

    def __mul__(self, s):
        return MatrixField.from_callable(lambda x: self(x) * s)

    __rmul__ = __mul__

    def __matmul__(self, other):
        """Lazy matrix-matrix product (matrix_expressions.h:80)."""
        if isinstance(other, MatrixField):
            return MatrixField.from_callable(lambda x: self(x) @ other(x))
        if isinstance(other, VectorField):
            return self.matvec(other)
        arr = jnp.asarray(other)
        if arr.ndim == 1:
            return self.matvec(arr)
        return MatrixField.from_callable(lambda x: self(x) @ arr)


def _unary(fn):
    def wrapper(field):
        f = _lift(field)
        return ScalarField(lambda x: fn(f(x)))

    return wrapper


# unary math on scalar expressions (scalar_expressions.h sin/cos/tan/exp/log)
sin = _unary(jnp.sin)
cos = _unary(jnp.cos)
tan = _unary(jnp.tan)
exp = _unary(jnp.exp)
log = _unary(jnp.log)
sqrt = _unary(jnp.sqrt)
